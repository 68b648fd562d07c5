"""How far the fused attention sublayer's (B6) bf16 dbias lies from its plain version.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.sublayer_dbias [--seeds N]

B6's bf16 backward forms ``do = dy . wproj^T`` on the wgmma mainloop, the
plain version (``attention_sublayer_bwd_reference``) with an f32
``torch.matmul``.  Both sum exact products of bf16 values in f32, in other
orders, so a few do elements round to the other bf16 neighbour, and dbias
(an f32 sum of B2's dS over the batch) moves with them.  :func:`readings`
gives, for one call, each relative to the plain dbias's largest magnitude:

- ``independent``: the kernel's dbias against the plain backward's, held at
  :data:`DBIAS_BAR`;
- ``kernel_do``: against B2's plain backward on the do that the kernel's own
  product made, which checks B2's backward alone, held at
  :data:`KERNEL_DO_BAR` (B2's dbias bar everywhere else);
- ``rounded`` and ``truncated`` (with ``controls``): two controls of bf16
  precision, the plain dbias rounded to bf16, and the plain dbias on a do
  truncated to bf16 (toward zero) instead of rounded, a do product that
  drifts by up to one bf16 ulp.  :data:`DBIAS_BAR` must lie below both, or
  the independent check could not tell such a fault from sound rounding.

For each B6 shape of a batch-32 train step, with a bias of small normal
draws and with every third key masked (-1e9), and ``--seeds`` seeds each,
``main`` prints these readings, then the largest sound reading and the
smallest control reading over all of them.  TF32 is off, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import block_attention as ba
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.tools import profile_sublayer as psl

# The bar of a bf16 call's dbias against the plain backward's, relative to
# its largest magnitude: above every sound reading with a margin, below
# both controls (PERF.md records the readings).
DBIAS_BAR = 1.5e-3
KERNEL_DO_BAR = 1e-4


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def truncate_to_bf16(t):
    """f32 ``t`` to bf16 toward zero (its low 16 bits dropped), not to the nearest."""
    return (t.float().contiguous().view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)


def _dbias(qkv, bias, do, num_heads: int, scale: float):
    """B2's plain dbias on the cotangent ``do``, summed over the windows for
    a one-window bias as B6's backward sums it."""
    full = ba._full_bias(bias, qkv.shape[1])
    dbias = wa.window_attention_v2_bwd_reference(qkv, full, do, num_heads, scale)[1]
    return dbias.sum(dim=0, keepdim=True) if bias.shape[0] == 1 else dbias


def readings(got, want, qkv, wproj, bias, dy, num_heads: int, scale: float, controls: bool = False) -> dict:
    """The readings of one bf16 call (CUDA tensors): ``got`` the kernel's
    dbias, ``want`` the plain backward's, on the inputs ``qkv``, ``wproj``,
    ``bias`` and ``dy`` of that call."""
    b, w, n, c = qkv.shape[0], qkv.shape[1], qkv.shape[2], wproj.shape[0]
    dy = dy.to(qkv.dtype).contiguous().view(-1, c)
    # The kernel path's do: the da of its proj layer's backward, which does
    # not depend on that layer's input (dy stands in for it).
    do = ba._dense_bwd(dy, dy, wproj, qkv.dtype)[2].view(b, w, n, c)
    out = {"independent": rel_err(got, want),
           "kernel_do": rel_err(got, _dbias(qkv, bias, do, num_heads, scale))}
    if controls:
        do32 = torch.matmul(dy.float(), wproj.float().T)  # the plain version's do before its rounding
        truncated = truncate_to_bf16(do32).view(b, w, n, c)
        out["rounded"] = rel_err(want.to(torch.bfloat16), want)
        out["truncated"] = rel_err(_dbias(qkv, bias, truncated, num_heads, scale), want)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sublayer_dbias: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"B6 bf16 dbias, relative to the plain dbias's largest magnitude; bar {DBIAS_BAR:g} [{card}]")
    worst = {"independent": 0.0, "kernel_do": 0.0, "rounded": float("inf"), "truncated": float("inf")}
    for s in psl.train_shapes(EDRLConfig()):
        for masked in (False, True):
            for seed in range(args.seeds):
                gen = torch.Generator(device="cuda").manual_seed(seed)
                inputs, scale = psl.sublayer_inputs(s, torch.bfloat16, gen)
                x, gamma, _, wqkv, _, wproj, _, bias = inputs
                if masked:
                    bias[..., 1::3] = -1e9
                h = s["heads"]
                with torch.no_grad():
                    y, qkv, xln = ba.attention_sublayer_fwd_kernel(*inputs, h, scale)
                    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
                    res = (x, xln, qkv, gamma, wqkv, wproj, bias, dy, h, scale)
                    got = ba.attention_sublayer_bwd_kernel(*res)[7]
                    want = ba.attention_sublayer_bwd_reference(*res)[7]
                    r = readings(got, want, qkv, wproj, bias, dy, h, scale, controls=True)
                print(f"{psl.label(s)} {'masked' if masked else 'normal'} bias, seed {seed}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)
                for k in ("independent", "kernel_do"):
                    worst[k] = max(worst[k], r[k])
                for k in ("rounded", "truncated"):
                    worst[k] = min(worst[k], r[k])
                del inputs, y, qkv, xln, dy, res, got, want
                torch.cuda.empty_cache()
    print(f"largest independent {worst['independent']:.3e}, largest kernel_do {worst['kernel_do']:.3e}; smallest "
          f"control: rounded {worst['rounded']:.3e}, truncated {worst['truncated']:.3e} (bar {DBIAS_BAR:g}) [{card}]")


if __name__ == "__main__":
    main()
