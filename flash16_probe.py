"""The flash kernel's two 16-bit kernels side by side on one NVIDIA GPU.

    python3 flash16_probe.py            # chip_smoke's shapes, then a head-width sweep
    python3 flash16_probe.py --sharp    # also inputs with softmax logits of std ~1

Builds the library from the sources here, prints ptxas's registers and spills
for each ``flash_fwd_16_sm90`` instantiation, then for each shape forces
``flash_fwd_16_sm90`` and ``flash_fwd_16`` in turns (mma_sync, sm90, sm90,
mma_sync) in bfloat16 and float16: ``ulp_error`` against the plain version
and the device time per call (``chip_smoke.device_ms``).  One JSON line a
shape.  The default inputs are chip_smoke's (q, k ~ 0.3 N(0, 1), v ~
N(0, 1)); ``--sharp`` adds q, k ~ N(0, 1), whose softmax is far from flat.
Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import re
import sys

import torch

from chip_smoke import ATTN_SHAPES, device_ms, time_ms

# head widths of 8 to 96 at a few lengths: where the 64-column blocks of
# flash_fwd_16_sm90 carry the most zero padding
SWEEP = [(BH, T, D, lens) for D in (8, 16, 24, 32, 48, 64, 96)
         for BH, T, lens in ((2, 300, (300, 0)), (4, 384, (300, 300, 200, 200)),
                             (16, 1024, (1000,) * 16), (8, 2048, (2000,) * 8))]


def ptxas_lines() -> None:
    from e2e_tts_tpu_torch.kernels.build import compiler_log, library

    library("flash_attention")
    name = None
    for line in compiler_log("flash_attention").splitlines():
        m = re.search(r"flash_fwd_16_sm90I(?:6__half|13__nv_bfloat16)Li(\d)ELi(\d)E", line)
        if "Compiling entry" in line:
            name = None if m is None else (
                ("bf16" if "bfloat16" in line else "fp16") + f" NWG={m.group(1)} DB={m.group(2)}")
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)


def compare(BH, T, D, lens, dtype, scale: float, seed: int = 0) -> dict:
    from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention, ulp_error

    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(BH, T, D, generator=g) * scale).to(dtype).cuda()
    k = (torch.randn(BH, T, D, generator=g) * scale).to(dtype).cuda()
    v = torch.randn(BH, T, D, generator=g).to(dtype).cuda()
    kv = torch.tensor(lens, dtype=torch.int32).cuda()
    ref = attention_plain(q, k, v, kv)
    names = (["sm90"] if D % 8 == 0 else []) + ["mma_sync"]
    row = dict(shape=(BH, T, D), dtype=str(dtype)[6:], qk_scale=scale)
    for name in names:
        out = flash_attention(q, k, v, kv, kernel=name)
        torch.cuda.synchronize()
        row[f"{name}_ulp_error"] = ulp_error(out, ref, v, kv)
    for name in names[::-1] + names:
        call = lambda: flash_attention(q, k, v, kv, kernel=name)  # noqa: E731
        row.setdefault(f"{name}_ms", []).append(time_ms(call))
        row.setdefault(f"{name}_dev_ms", []).append(device_ms(call))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash16_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    ptxas_lines()
    scales = (0.3, 1.0) if "--sharp" in sys.argv[1:] else (0.3,)
    for scale in scales:
        for BH, T, D, lens in list(ATTN_SHAPES) + (SWEEP if scale == 0.3 else []):
            for dtype in (torch.bfloat16, torch.float16):
                print(json.dumps(compare(BH, T, D, lens, dtype, scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
