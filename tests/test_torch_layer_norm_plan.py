"""B4's launch plan and the backward's summation order, on the CPU.

``layer_norm.layer_norm_plan`` mirrors ``ln_plan`` in
``csrc/layer_norm.cuh`` (the card test holds the two equal).  Here it is
held to a hand count at every shape a batch-32 train step gives B4, in the
backward (the ``use_fused_ln`` configuration) and in its residual form (B6's
LayerNorm backward), on a 132-SM card: the partials' bytes stay within a
tenth of the call's and every row is taken exactly once.  Then a plain f32
emulation of the kernel's order of summation for dgamma and dbeta (each
thread's rows into its registers, the CTA's row groups in order into one
partial row, the partials in the column-sum kernel's slices) is held to the
Pallas VJP in interpret mode at atol 1e-4 / rtol 1e-4, the bar of
``tests/test_torch_fused_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.layer_norm import fused_layer_norm as jax_fused_layer_norm
from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.tools import profile_layer_norm as pln

SMS = 132
SUM_SLICES = 16  # csrc/layer_norm.cuh kLnSumSlices

# (M, C): (G threads per row, R row groups per CTA, CTAs), bf16, counted by
# hand from the rule in layer_norm_plan's docstring.  Backward: 1024 resident
# threads per SM, so two waves of 512-thread CTAs (480 at C = 768) where the
# partials' bytes allow, 16 P C <= 6 M C / 10, i.e. P <= 6 M / 160: at
# M = 4608 that is 172 (one wave), at M = 6912 259 (one wave).
BACKWARD = {
    (294912, 128): (16, 32, 264), (73728, 512): (64, 8, 264), (73728, 256): (32, 16, 264),
    (18432, 1024): (128, 4, 264), (18432, 512): (64, 8, 264), (4608, 2048): (256, 2, 132),
    (4608, 1024): (128, 4, 132), (6912, 768): (96, 5, 132),
}
# The residual form reads an f32 dy (10 bytes per element); 512 resident
# threads per SM, so one wave of 132 at every shape.
RESIDUAL = {
    (294912, 128): (16, 32, 132), (73728, 256): (32, 16, 132), (18432, 512): (64, 8, 132),
    (4608, 1024): (128, 4, 132), (6912, 768): (96, 5, 132),
}
# The forward: one wave of SMs x min(4, 1024 // (R G)) CTAs of 256 threads
# (192 at C = 768, also 4 per SM).
FORWARD = {
    (294912, 128): (16, 16, 528), (73728, 512): (64, 4, 528), (73728, 256): (32, 8, 528),
    (18432, 1024): (128, 2, 528), (18432, 512): (64, 4, 528), (4608, 2048): (256, 1, 528),
    (4608, 1024): (128, 2, 528), (6912, 768): (96, 2, 528),
}


def test_hand_counts_cover_the_train_steps_shapes():
    cfg = EDRLConfig()
    assert set(pln.ln_shapes(cfg)) == set(BACKWARD) == set(FORWARD)
    assert set(pln.residual_shapes(cfg)) == set(RESIDUAL)


def _covered_once(plan, m):
    """Row group i of the grid takes rows i, i + T, ... (T = CTAs x R)."""
    t = plan.ctas * plan.rows_per_cta
    rows = (np.arange(t)[:, None] + t * np.arange(-(-m // t))[None, :]).ravel()
    rows = np.sort(rows[rows < m])
    return rows.size == m and (rows == np.arange(m)).all()


@pytest.mark.parametrize("kind,table", [("backward", BACKWARD), ("residual", RESIDUAL), ("forward", FORWARD)])
def test_plan_at_every_train_shape(kind, table):
    for (m, c), (g, r, ctas) in table.items():
        plan = ln.layer_norm_plan(m, c, torch.bfloat16, SMS, kind)
        assert plan == (g, r, ctas, 0 if kind == "forward" else ctas), (m, c, plan)
        assert g * 8 == c  # 8 elements per thread at every train shape
        assert _covered_once(plan, m), (m, c)
        call = pln.call_bytes(m, c, kind)
        assert ln.partial_bytes(plan, c) <= 0.1 * call, (m, c, ln.partial_bytes(plan, c) / call)


@pytest.mark.parametrize("m,c,dtype,kind,want", [
    (37, 128, torch.bfloat16, "backward", (16, 32, 1)),    # 37 * 6 // 160 = 1 partial
    (1000, 768, torch.bfloat16, "backward", (96, 5, 37)),  # fewer rows than one wave allows: 6000 // 160
    (3, 1152, torch.bfloat16, "backward", (288, 1, 1)),    # odd C / 128: 4 per thread, whole warps
    (3, 1152, torch.float32, "forward", (288, 1, 3)),      # no more CTAs than row groups
    (1000, 384, torch.float32, "backward", (96, 5, 75)),   # 12 bytes per element: 12000 // 160
    (100000, 2048, torch.float32, "backward", (256, 2, 132)),  # f32: 512 resident threads per SM
])
def test_plan_at_odd_shapes(m, c, dtype, kind, want):
    plan = ln.layer_norm_plan(m, c, dtype, SMS, kind)
    assert plan[:3] == want
    assert _covered_once(plan, m)


@pytest.mark.parametrize("c", [0, 64, 200, 2176, 4096])
def test_plan_refuses_other_widths(c):
    with pytest.raises(ValueError, match="multiple of 128"):
        ln.layer_norm_plan(100, c, torch.bfloat16, SMS, "backward")


def test_plan_refuses_no_rows_and_unknown_kinds():
    for m, kind in ((0, "backward"), (10, "sideways")):
        with pytest.raises(ValueError):
            ln.layer_norm_plan(m, 128, torch.bfloat16, SMS, kind)


def emulated_dgamma_dbeta(x, dy, gamma, plan, eps=1e-6):
    """dgamma and dbeta [C] summed in the kernels' order, in f32: row group
    i of the grid adds its rows i, i + T, ... in turn (T = CTAs x R), a
    CTA's R row groups are added in group order into its partial row, and
    slice s of the column sums adds partial rows s, s + 16, ... in order
    before the 16 slices are added in order."""
    xf, dyf = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    terms = torch.stack([dyf * xhat, dyf])  # [2, M, C]
    m, c = x.shape
    t = plan.ctas * plan.rows_per_cta
    acc = torch.zeros((2, t, c))
    for k in range(0, m, t):
        n = min(t, m - k)
        acc[:, :n] = acc[:, :n] + terms[:, k:k + n]
    acc = acc.view(2, plan.ctas, plan.rows_per_cta, c)
    part = acc[:, :, 0]
    for r in range(1, plan.rows_per_cta):
        part = part + acc[:, :, r]
    slices = torch.zeros((2, SUM_SLICES, c))
    for p in range(plan.partials):
        slices[:, p % SUM_SLICES] = slices[:, p % SUM_SLICES] + part[:, p]
    out = slices[:, 0]
    for s in range(1, SUM_SLICES):
        out = out + slices[:, s]
    return out[0], out[1]


@pytest.mark.parametrize("m,c,dtype,sms", [
    (4000, 128, "bf16", 16),   # 32 CTAs of 32 row groups, ~4 rows per group; 2 partial rows per slice
    (4000, 768, "bf16", 16),   # row groups of three warps, 25 rows each
    (1500, 384, "f32", 8),     # odd C / 128: 4 per thread
    (37, 256, "f32", 132),     # fewer rows than one wave allows: two partials
])
def test_summation_order_matches_the_pallas_vjp(m, c, dtype, sms):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(m + c)
    x = (rng.normal(size=(m, c)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    _, vjp = jax.vjp(lambda a, g, b: jax_fused_layer_norm(a, g, b, 1e-6, True), jx, jnp.asarray(gamma),
                     jnp.asarray(beta))
    _, want_dg, want_db = vjp(jdy)
    plan = ln.layer_norm_plan(m, c, tdt, sms, "backward")
    assert plan.partials > 1 or m < 100
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tdy = torch.tensor(np.asarray(jdy.astype(jnp.float32))).to(tdt)
    dg, db = emulated_dgamma_dbeta(tx, tdy, torch.tensor(gamma), plan)
    for got, want in ((dg, want_dg), (db, want_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
