"""Rank function of ``test_torch_port_train.py``'s gloo world of 2
(spawned processes import this module by name). It imports no JAX, flax or
JAX package: each rank of the world starts and runs on torch alone, which
keeps the world light beside the other worlds and JAX compiles of a
parallel test run."""

import torch
import torch.nn.functional as F

from horovod_tpu_torch import context, convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.parallel import dp as tdp

WORLD = 2
STEPS = 3
LR = 1e-2
VARIANTS = ["replicated", "sharded", "sharded_fused"]
KW = {
    "replicated": dict(sharded=False),
    "sharded": dict(sharded=True, fused_update=False),
    "sharded_fused": dict(sharded=True, fused_update=True),
}


def port_train(params, tokens):
    """One rank of the gloo world: every variant, from the same start."""
    rank = context.rank()
    rows = torch.from_numpy(tokens[2 * rank:2 * rank + 2]).long()
    out = {}
    for variant in VARIANTS:
        cfg = GPT2Config.tiny(dtype=torch.float32, use_flash=True)
        model = GPT2LMModel(cfg, device="cpu")
        model.load_state_dict(convert.params_from_flax({"params": params}))

        def loss_fn(p, t, model=model):
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

        opt = (topt.adamw(LR) if variant == "replicated"
               else topt.fused_adamw(LR))
        step, wopt = tdp.make_train_step(loss_fn, opt, device="cpu",
                                         **KW[variant])
        state = tdp.init_state(model, wopt)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, rows)
            losses.append(float(loss))
        assert int(state.step) == STEPS
        out[variant] = (
            losses, convert.params_to_flax(state.params, cfg.n_heads)["params"]
        )
    return out
