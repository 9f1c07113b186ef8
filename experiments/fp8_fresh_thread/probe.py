"""Calls the fp8 matmul's C entry (``hvt_fp8_matmul``) through ctypes from
a thread that has made no CUDA call, and prints the tree, the entry's
argument count and the ``cudaError_t`` it returned (0: launched; 1:
``cudaErrorInvalidValue``, the tensor maps refused for want of a bound
context). Run on a card, once for each checkout to compare:

    python3 experiments/fp8_fresh_thread/probe.py TREE

where TREE is the root of a checkout (this one: ``.``). An entry that takes
no device index (17 arguments) is called without one.
"""

import sys
import threading

import torch

sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch.ops import quantization as tq  # noqa: E402

m, n, k = 256, 256, 512
x = torch.randn(m, k, device="cuda").to(torch.float8_e4m3fn)
w = torch.randn(n, k, device="cuda").to(torch.float8_e4m3fn)
scale = torch.ones((), device="cuda")
out = torch.zeros(m, n, device="cuda")
entry = tq._kernel("hvt_fp8_matmul")
args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), None, scale.data_ptr(),
        None, m, n, k, k, k, n, 0, 0, 0, 1]
if len(entry.argtypes) == 18:
    args.append(x.device.index)
args.append(torch.cuda.current_stream().cuda_stream)
torch.cuda.synchronize()
box = {}
t = threading.Thread(target=lambda: box.update(rc=entry(*args)))
t.start()
t.join()
torch.cuda.synchronize()
print(tq.__file__, "args", len(entry.argtypes), "rc", box["rc"], flush=True)
