#!/usr/bin/env python3
"""Time the two flash-attention kernels of the PyTorch/CUDA port at
RecurrentGemma-9B's prefill shape, and check each against the plain
version at a few shapes, on one NVIDIA GPU.

    python3 tools/flash_forms.py     # from the repository root

Prints the card; per flash kernel of the built library, its count of
tensor-core instructions (HMMA) and asynchronous copies (LDGSTS) in the
SASS that ``cuobjdump`` shows; max|err| of the CUDA-core (kernel 1) and
tensor-core (kernel 2) kernels forced through the library's measuring
entry point; then device ms per call (CUDA events, after warm-up) at
(4, 3000, 16, 1, 256) with window 2048: both kernels in f32, the
tensor-core kernel with the GQA heads not packed (K/V expanded), in
bf16, and ``scaled_dot_product_attention`` with the dense window mask.
"""
import collections
import pathlib
import re
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import flash_kernel, max_err, qkv, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CASES = [(1, 200, 8, 2, 64, None), (1, 200, 8, 2, 128, 64),
         (1, 300, 16, 1, 256, 128), (2, 77, 8, 2, 256, None),
         (1, 1000, 16, 1, 256, 512), (2, 37, 4, 1, 48, 7),
         (1, 16, 4, 4, 32, None), (1, 3000, 16, 1, 256, 2048)]


def sass_counts(lib_path):
    """{kernel: Counter of HMMA / LDGSTS opcodes} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            continue
        op = re.search(r"\b(HMMA|LDGSTS)\.(\S+)", line)
        if name and "flash" in name and op:
            counts.setdefault(name, collections.Counter())[
                f"{op.group(1)}.{op.group(2)}"] += 1
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_forms: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.library()
    for name, counts in sorted(sass_counts(_build.build()).items()):
        kernel = re.search(r"(flash_(?:tc|fma)_kernel)I(\w+?)EEv", name)
        print(f"sass {kernel.group(1) if kernel else name} "
              f"<{kernel.group(2) if kernel else ''}>: {dict(counts)}")
    dev = torch.device("cuda")
    for b, s, h, kv, hd, w in CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            ref = fa.flash_attention_plain(q, k, v, window=w)
            for kernel in (1, 2):
                err = max_err(flash_kernel(q, k, v, w, kernel), ref)
                print(f"{(b, s, h, kv, hd, w)} {str(dt)[6:]} kernel {kernel}"
                      f" max|err| {err:.3g}")
    q, k, v = qkv(dev, 4, 3000, 16, 1, 256)
    for kernel in (2, 1):
        ms = time_ms(lambda: flash_kernel(q, k, v, 2048, kernel), iters=5,
                     warmup=2)[0]
        print(f"RG f32 kernel {kernel}: {ms:.4f} ms")
    ku, vu = k.expand(-1, -1, 16, -1), v.expand(-1, -1, 16, -1)
    print(f"RG f32 tensor cores, heads not packed: "
          f"{time_ms(lambda: flash_kernel(q, ku, vu, 2048, 2), 5, 2)[0]:.4f}"
          " ms")
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    print(f"RG bf16 tensor cores: "
          f"{time_ms(lambda: flash_kernel(qb, kb, vb, 2048, 2), 5, 2)[0]:.4f}"
          " ms")
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    i = torch.arange(3000, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 2048)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 5, 2)[0]
    print(f"RG f32 SDPA: {sdpa:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
