"""Model-zoo lint harness: build and statically lint every model of the
port's zoo — the port of ``horovod_tpu/analysis/harness.py``.

Each entry builds the exact DP train step ``parallel.dp.make_train_step``
assembles (replicated or ZeRO-1 sharded, with or without the overlap
pipeline) inside a simulated world of :data:`WORLD` ranks
(:func:`.record.simulated_world`), and records it under fake tensors, so
the whole sweep runs on the CPU with no process group and zero FLOPs —
the reference's 8 virtual devices. Each rank's batch is its 1/8 of the
reference's global batch. This is what ``horovod_tpu_torch/tools/
hvdtpu_lint.py``, ``run_lints.py`` and the port's lint tests drive.

Configs default to the models' ``tiny`` shapes (the reference's): the
invariants under lint are size-independent and tiny records take a
fraction of a second. ``size="small"`` (the reference's ``"full"``, which
is accepted too) builds the benchmark-scale shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .findings import LintFinding
from .record import simulated_world

WORLD = 8  # the reference's virtual CPU mesh


def _xent(logits, labels):
    # Always reduce the loss in fp32: a bf16 scalar loss would (rightly)
    # trip the low-precision-collective rule on its world-average psum.
    return F.cross_entropy(logits.float().flatten(0, -2), labels.flatten())


@dataclasses.dataclass
class ModelSpec:
    """One lintable model: the module, the loss over (params, batch), and
    this rank's batch (real tensors from a numpy seed)."""

    name: str
    model: torch.nn.Module
    loss_fn: Callable[[Any, Any], Any]
    batch: Any


def _small(size: str) -> bool:
    return size in ("small", "full")


def _tokens(rows: int, cols: int, vocab: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, vocab, (rows, cols))).long()


def _lm_spec(name, model, vocab, batch, seq, with_aux=False) -> ModelSpec:
    def loss_fn(params, tokens, model=model):
        out = torch.func.functional_call(model, params, (tokens[:, :-1],))
        if with_aux:
            logits, aux = out
            return (_xent(logits, tokens[:, 1:])
                    + model.cfg.aux_loss_weight * aux)
        return _xent(out, tokens[:, 1:])

    return ModelSpec(name, model, loss_fn,
                     _tokens(batch // WORLD, seq + 1, vocab))


def _build_mlp(size, compute_dtype="") -> ModelSpec:
    from ..models import MLP

    model = MLP(in_features=784, device="cpu")

    def loss_fn(params, b, model=model):
        x, y = b
        return _xent(torch.func.functional_call(model, params, (x,)), y)

    rs = np.random.RandomState(0)
    n = 64 // WORLD
    batch = (torch.from_numpy(rs.standard_normal((n, 784)).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, (n,))).long())
    return ModelSpec("mlp", model, loss_fn, batch)


def _build_resnet(size, depth=18, compute_dtype=""):
    from ..models import ResNet18, ResNet50

    cls = {18: ResNet18, 50: ResNet50}[depth]
    hw, classes, batch = (224, 1000, 128) if _small(size) else (32, 10, 32)
    model = cls(num_classes=classes, dtype=torch.bfloat16, device="cpu")
    # Inference-mode normalization, as the reference's harness applies
    # with its batch statistics closed over: the gradient and collective
    # layout under lint is train mode's minus the statistics' update.
    model.eval()

    def loss_fn(params, b, model=model):
        x, y = b
        return _xent(torch.func.functional_call(model, params, (x,)), y)

    rs = np.random.RandomState(0)
    n = batch // WORLD
    x = torch.from_numpy(rs.standard_normal((n, 3, hw, hw)).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, classes, (n,))).long()
    return ModelSpec(f"resnet{depth}", model, loss_fn, (x, y))


def _gpt_cfg(size, compute_dtype):
    from ..models import GPT2Config

    make = GPT2Config.small if _small(size) else GPT2Config.tiny
    return make(param_dtype=torch.float32, compute_dtype=compute_dtype or "")


def _build_transformer(size, compute_dtype="") -> ModelSpec:
    from ..models import Transformer

    cfg = _gpt_cfg(size, compute_dtype)
    batch, seq = (16, 1024) if _small(size) else (16, 32)
    model = Transformer(cfg, lm_head=True, device="cpu")
    return _lm_spec("transformer", model, cfg.vocab_size, batch, seq)


def _build_gpt2(size, compute_dtype="") -> ModelSpec:
    from ..models import GPT2LMModel

    cfg = _gpt_cfg(size, compute_dtype)
    batch, seq = (16, 1024) if _small(size) else (16, 32)
    model = GPT2LMModel(cfg, device="cpu")
    return _lm_spec("gpt2", model, cfg.vocab_size, batch, seq)


def _build_bert(size, compute_dtype="") -> ModelSpec:
    from ..models import BertConfig, BertModel

    make = BertConfig.base if _small(size) else BertConfig.tiny
    cfg = make(param_dtype=torch.float32, compute_dtype=compute_dtype or "")
    batch, seq = (32, 512) if _small(size) else (16, 32)
    model = BertModel(cfg, device="cpu")

    def loss_fn(params, b, model=model):
        tokens, targets = b
        return _xent(torch.func.functional_call(model, params, (tokens,)),
                     targets)

    n = batch // WORLD
    spec_batch = (_tokens(n, seq, cfg.vocab_size),
                  _tokens(n, seq, cfg.vocab_size, seed=1))
    return ModelSpec("bert", model, loss_fn, spec_batch)


def _build_vit(size, compute_dtype="") -> ModelSpec:
    from ..models import ViT, ViTConfig

    make = ViTConfig.large if _small(size) else ViTConfig.tiny
    cfg = make(param_dtype=torch.float32, compute_dtype=compute_dtype or "")
    batch = 128 if _small(size) else 16
    model = ViT(cfg, device="cpu")

    def loss_fn(params, b, model=model):
        images, labels = b
        return _xent(torch.func.functional_call(model, params, (images,)),
                     labels)

    rs = np.random.RandomState(0)
    n = batch // WORLD
    images = torch.from_numpy(rs.standard_normal(
        (n, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, cfg.num_classes, (n,))).long()
    return ModelSpec("vit", model, loss_fn, (images, labels))


def _build_moe(size, compute_dtype="") -> ModelSpec:
    from ..models import MoEConfig, SwitchTransformerLM

    if _small(size):
        cfg = MoEConfig(param_dtype=torch.float32)
        batch, seq = 16, 1024
    else:
        cfg = MoEConfig(vocab_size=512, max_len=128, d_model=64, n_heads=4,
                        n_layers=2, d_ff=128, num_experts=4,
                        param_dtype=torch.float32)
        batch, seq = 16, 32
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype or "")
    model = SwitchTransformerLM(cfg, device="cpu")
    return _lm_spec("moe", model, cfg.vocab_size, batch, seq, with_aux=True)


BUILDERS: Dict[str, Callable[..., ModelSpec]] = {
    "mlp": _build_mlp,
    "resnet18": lambda size, compute_dtype="": _build_resnet(size, 18),
    "resnet50": lambda size, compute_dtype="": _build_resnet(size, 50),
    "transformer": _build_transformer,
    "gpt2": _build_gpt2,
    "bert": _build_bert,
    "vit": _build_vit,
    "moe": _build_moe,
}
# Models whose config consumes compute_dtype (the transformer family, where
# ops/fp8.Fp8Linear is injected): only these fork a spec per compute dtype
# (fp8 adds fp8_* scale state to the parameters).
_COMPUTE_DTYPE_MODELS = frozenset(
    {"transformer", "gpt2", "bert", "vit", "moe"})
# The fast sweep covers each model family once.
SWEEP_MODELS: Tuple[str, ...] = (
    "mlp", "resnet18", "transformer", "gpt2", "bert", "vit", "moe",
)

_SPEC_CACHE: Dict[Tuple[str, str, str], ModelSpec] = {}


def get_spec(name: str, size: str = "tiny",
             compute_dtype: str = "") -> ModelSpec:
    """Build (and memoize) one model's lint spec; its weights come from
    seed 0 without touching the global RNG."""
    cd = compute_dtype if name in _COMPUTE_DTYPE_MODELS else ""
    key = (name, size, cd)
    if key not in _SPEC_CACHE:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            _SPEC_CACHE[key] = BUILDERS[name](size, compute_dtype=cd)
    return _SPEC_CACHE[key]


def variant_label(var: Dict) -> str:
    """One canonical label per sweep variant — shared by the lint and
    memplan sweeps, the CLIs and the baseline JSON keys."""
    label = "sharded" if var.get("sharded") else "replicated"
    if var.get("overlap"):
        label += f"+overlap@k{var.get('accum_steps', 1)}"
    elif var.get("accum_steps", 1) > 1:
        label += f"+accum@k{var['accum_steps']}"
    if var.get("quant"):
        label += f"+quant-{var['quant']}"
    if var.get("fused_update"):
        label += "+fused-update"
    if var.get("remat"):
        label += f"+remat-{var['remat']}"
    if var.get("compute_dtype"):
        label += f"+{var['compute_dtype']}"
    if var.get("act_quant"):
        label += f"+act-quant-{var['act_quant']}"
    return label


# Built steps and their records, keyed by (model, size, variant, env).
_STEP_CACHE: Dict[Tuple, Tuple[Any, Any, Any]] = {}
_RECORD_CACHE: Dict[Tuple, Any] = {}


def _variant_key(name, size, sharded=False, overlap=False, accum_steps=1,
                 quant="", fused_update=False, remat="", compute_dtype="",
                 act_quant="") -> Tuple:
    from ..utils import env as _env

    # The env-derived build knobs are part of the build: a cached record
    # must never outlive the env it was built under.
    env_sig = (
        _env.fusion_threshold_bytes(), _env.overlap_stagger(),
        _env.overlap_default(), _env.overlap_accum_steps(),
        _env.quant_mode(), _env.quant_block(), _env.fused_update_default(),
        _env.remat_mode(), _env.guard_default(), _env.compute_dtype_mode(),
        _env.act_quant_mode(), _env.fp8_amax_history(),
    )
    return (env_sig, name, size, bool(sharded), bool(overlap),
            int(accum_steps), quant or "", bool(fused_update), remat or "",
            compute_dtype or "", act_quant or "")


def build_step(
    name: str,
    *,
    sharded: bool = False,
    overlap: bool = False,
    accum_steps: int = 1,
    size: str = "tiny",
    quant: str = "",
    fused_update: bool = False,
    remat: str = "",
    compute_dtype: str = "",
    act_quant: str = "",
):
    """Build (and memoize) one model-variant's DP step and its state in
    the simulated world: ``(step, state, batch)``. Call the step's
    analysis surfaces inside ``simulated_world(WORLD)`` (the functions
    below do)."""
    from .. import optimizer as _opt
    from ..ops.compression import Compression
    from ..parallel import dp

    key = _variant_key(name, size, sharded, overlap, accum_steps, quant,
                       fused_update, remat, compute_dtype, act_quant)
    hit = _STEP_CACHE.get(key)
    if hit is not None:
        return hit
    spec = get_spec(name, size, compute_dtype=compute_dtype)
    optimizer = (_opt.fused_adamw(1e-4) if fused_update
                 else _opt.adamw(1e-4))
    with simulated_world(WORLD):
        step, opt = dp.make_train_step(
            spec.loss_fn, optimizer, sharded=sharded, overlap=overlap,
            accum_steps=accum_steps, lint=False,
            compression=(Compression.by_name(quant) if quant
                         else Compression.none),
            fused_update=fused_update or None, remat=remat or None,
            compute_dtype=compute_dtype, act_quant=act_quant,
            autotune=False, publish=0, guard=False, device="cpu")
        params = {k: v.detach().clone()
                  for k, v in spec.model.named_parameters()}
        state = dp.init_state(params, opt)
    batch = spec.batch
    if accum_steps > 1:
        batch = _repeat(batch, accum_steps)
    _STEP_CACHE[key] = (step, state, batch)
    return step, state, batch


def _repeat(batch, k: int):
    """``k`` microbatches of this rank's batch, stacked along dim 0."""
    if isinstance(batch, tuple):
        return tuple(_repeat(b, k) for b in batch)
    return torch.cat([batch] * k)


def traced_step(name: str, size: str = "tiny", **variant):
    """``(step, state, batch, record)`` with the record memoized by
    (model, variant): lint, memplan and cert share one record."""
    key = _variant_key(name, size, **variant)
    step, state, batch = build_step(name, size=size, **variant)
    rec = _RECORD_CACHE.get(key)
    if rec is None:
        with simulated_world(WORLD):
            rec = step.trace(state, batch)
        _RECORD_CACHE[key] = rec
    return step, state, batch, rec


def clear_caches() -> None:
    """Drop memoized specs, builds and records."""
    _STEP_CACHE.clear()
    _RECORD_CACHE.clear()
    _SPEC_CACHE.clear()


def lint_model(name: str, *, size: str = "tiny",
               allowlist: Sequence[str] = (), **variant
               ) -> Tuple[LintFinding, ...]:
    """Build the model's DP step and return its static findings
    (``sharded``, ``overlap``, ``accum_steps``, ``quant``,
    ``fused_update``, ``remat``, ``compute_dtype``, ``act_quant`` as in
    the reference)."""
    from .findings import apply_allowlist

    step, state, batch, rec = traced_step(name, size=size, **variant)
    with simulated_world(WORLD):
        findings = step.lint(state, batch, jaxpr=rec)
    return apply_allowlist(findings, tuple(allowlist))


def memplan_model(name: str, *, size: str = "tiny", **variant):
    """The per-device :class:`~.memory.MemoryPlan` of one model-variant,
    sharing the cached build and record with the lint sweep."""
    step, state, batch, rec = traced_step(name, size=size, **variant)
    with simulated_world(WORLD):
        return step.memplan(state, batch, jaxpr=rec)


def memplan_sweep(
    models: Sequence[str] = SWEEP_MODELS,
    *,
    variants: Optional[Sequence[Dict]] = None,
    size: str = "tiny",
    baselines: Optional[Dict[str, int]] = None,
    budget_bytes: Optional[int] = None,
    regression_tolerance: float = 1.05,
) -> Dict[str, Dict[str, Dict]]:
    """Plan every model under every variant and gate each plan through
    the memory rules: ``{model: {variant: {"plan": MemoryPlan,
    "findings": (...)}}}``. ``baselines`` maps ``"model/variant"`` to
    checked-in peak bytes for the ``peak-regression`` rule; a swept key
    missing from a provided map is itself a finding."""
    from . import rules as _rules
    from .findings import Severity

    if variants is None:
        variants = SWEEP_VARIANTS
    out: Dict[str, Dict[str, Dict]] = {}
    for name in models:
        out[name] = {}
        for var in variants:
            label = variant_label(var)
            plan = memplan_model(name, size=size, **var)
            key = f"{name}/{label}"
            baseline = (baselines or {}).get(key)
            findings = _rules.rule_memory(
                plan, budget_bytes=budget_bytes, baseline_bytes=baseline,
                baseline_key=key, regression_tolerance=regression_tolerance)
            if baselines is not None and baseline is None:
                findings += (LintFinding(
                    rule="peak-regression", severity=Severity.ERROR,
                    message=(
                        f"no checked-in peak baseline for {key}; "
                        "regenerate horovod_tpu_torch/tools/"
                        "memplan_baselines.json with hvdtpu_memplan.py "
                        "--write-baselines"),
                    provenance=key),)
            out[name][label] = {"plan": plan, "findings": findings}
    return out


def lint_parity(name: str, *, size: str = "tiny",
                tolerance: float = 1.1) -> Tuple[LintFinding, ...]:
    """Replicated-vs-sharded byte parity for one model: both builds
    recorded and handed to :func:`horovod_tpu_torch.analysis.
    static_parity`."""
    from . import static_parity

    rep, shard = (build_step(name, size=size, sharded=sharded)
                  for sharded in (False, True))
    with simulated_world(WORLD):
        return static_parity(
            rep[0]._program, rep[1:], shard[0]._program, shard[1:],
            params=shard[1].params, world=WORLD, tolerance=tolerance)


# The canonical zoo variants: one list shared by the lint sweep, the
# memplan sweep and the baseline JSON.
SWEEP_VARIANTS: Tuple[Dict, ...] = (
    {"sharded": False},
    {"sharded": True},
    {"sharded": True, "overlap": True, "accum_steps": 2},
    {"sharded": False, "quant": "int8"},
    {"sharded": True, "fused_update": True},
    # fp8 training matmuls are replicated-path only; act-quant rides the
    # sharded path.
    {"sharded": False, "compute_dtype": "fp8"},
    {"sharded": True, "act_quant": "int8"},
)


def sweep(models: Sequence[str] = SWEEP_MODELS, *,
          variants: Sequence[Dict] = SWEEP_VARIANTS, size: str = "tiny",
          allowlist: Sequence[str] = ()
          ) -> Dict[str, Dict[str, Tuple[LintFinding, ...]]]:
    """Lint every model under every variant; returns
    ``{model: {variant_label: findings}}``."""
    return {
        name: {variant_label(var): lint_model(name, size=size,
                                              allowlist=allowlist, **var)
               for var in variants}
        for name in models
    }


def cert_model(name: str, *, size: str = "tiny", **variant):
    """ScheduleCert of one model-variant build, from the shared record."""
    step, state, batch, rec = traced_step(name, size=size, **variant)
    with simulated_world(WORLD):
        return step.certify(state, batch, jaxpr=rec)


def cert_sweep(models: Sequence[str] = SWEEP_MODELS, *,
               variants: Sequence[Dict] = SWEEP_VARIANTS,
               size: str = "tiny") -> Dict[str, Dict[str, Any]]:
    """Certify every model under every variant; returns
    ``{model: {variant_label: ScheduleCert}}``."""
    return {
        name: {variant_label(var): cert_model(name, size=size, **var)
               for var in variants}
        for name in models
    }
