"""CPU tests of ``edrl_tpu_torch/tools/mlp_replay.py``: the one-ulp test, the
witness that accounts for B5's bf16 rounding flips, and the step's draws."""

import numpy as np
import pytest
import torch

from edrl_tpu_torch.kernels import fused_mlp as fm
from edrl_tpu_torch.tools import mlp_replay as mr


def _mlp_args(seed, m=64, c=128, h=512):
    r = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy((scale * r.standard_normal(s)).astype(np.float32))  # noqa: E731
    return t(m, c), t(c, h, scale=c ** -0.5), t(h, scale=0.1), t(h, c, scale=h ** -0.5), t(c, scale=0.1), t(m, c)


def _nudged(t, seed):
    """``t`` moved by a few f32 ulps of itself, as another summation order does."""
    r = np.random.default_rng(seed)
    return t * (1 + torch.from_numpy(r.integers(-4, 5, size=t.shape).astype(np.float32)) * 2.0 ** -23)


def test_one_ulp_apart():
    a = torch.tensor([1.0, 1.0, -2.0, 3.0, 1.0])
    up = torch.nextafter(a.to(torch.bfloat16), torch.tensor(10.0, dtype=torch.bfloat16)).float()
    b = torch.tensor([up[0].item(), 1.0, up[2].item(), 3.0 + 2 * (up[3].item() - 3.0), -1.0])
    assert mr.one_ulp_apart(a, b).tolist() == [True, False, True, False, False]


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_witness_on_the_same_inputs_is_the_plain_version(which):
    u, w1, b1, w2, b2, dy = _mlp_args(0)
    plain, args = ((fm.fused_mlp_reference, (u, w1, b1, w2, b2)) if which == "forward"
                   else (fm.fused_mlp_bwd_reference, (u, dy, w1, b1, w2)))
    got, flips, wider = mr.witness(plain, args, args)
    want = plain(*args)
    for g, w in zip(mr._flat(got), mr._flat(want)):
        assert torch.equal(g, w)
    assert (flips, wider) == (0, 0)
    assert fm._bf16(torch.tensor([1.0 + 2.0 ** -9])).item() == 1.0  # the rounding is restored


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_witness_takes_the_card_inputs_roundings(which):
    """Inputs a few f32 ulps apart: some bf16 roundings land one ulp apart, and
    the witness on the CPU's inputs then lies much nearer the plain version on
    the card's inputs than the plain version on the CPU's does.  (A few
    roundings of values near zero, where an f32 ulp of the inputs is many bf16
    ulps of the value, differ by more: the witness keeps those.)"""
    u, w1, b1, w2, b2, dy = _mlp_args(1, m=256)
    u_card, dy_card = _nudged(u, 2), _nudged(dy, 3)
    if which == "forward":
        plain, args, card_args = fm.fused_mlp_reference, (u, w1, b1, w2, b2), (u_card, w1, b1, w2, b2)
    else:
        plain, args, card_args = fm.fused_mlp_bwd_reference, (u, dy, w1, b1, w2), (u_card, dy_card, w1, b1, w2)
    got, flips, wider = mr.witness(plain, args, card_args)
    card = mr._flat(plain(*card_args))
    raw = max(mr.rel_err(c, w) for c, w in zip(card, mr._flat(plain(*args))))
    held = max(mr.rel_err(c, w) for c, w in zip(card, mr._flat(got)))
    assert flips > 0 and wider < flips
    assert held <= 1e-5 and raw >= 10 * held, (raw, held)


def test_witness_refuses_calls_that_round_differently():
    def plain(x):
        return fm._bf16(x) if x.sum() > 0 else fm._bf16(fm._bf16(x))

    for args, card_args in (((torch.ones(3),), (-torch.ones(3),)), ((-torch.ones(3),), (torch.ones(3),))):
        with pytest.raises(RuntimeError, match="rounded different tensors"):
            mr.witness(plain, args, card_args)


def test_small_draws_are_seeded_and_shaped():
    model = mr.slice_config().model
    a, b = mr.small_draws(model, "cpu"), mr.small_draws(model, "cpu")
    assert len(a) == 2
    for da, db in zip(a, b):
        assert da["guided_uniform"][0].shape == (mr.BATCH, model.num_classes, model.z_dim)
        assert da["eprl_eps"][1].shape == (model.num_classes, model.sample_num, model.z_dim)
        assert da["dropout_masks"][1][0].shape == (mr.BATCH, model.oct_tokens, 2 * model.z_dim)
        assert all(torch.equal(x, y) for x, y in zip(da["eprl_eps"], db["eprl_eps"]))
    assert not torch.equal(mr.small_draws(model, "cpu", 7)[0]["eprl_eps"][0], a[0]["eprl_eps"][0])


def test_slice_config_routes_every_layer_norm_and_mlp():
    m = mr.slice_config().model
    assert m.use_fused_ln and m.use_fused_mlp
    assert m.swin_embed_dim % 128 == 0 and m.oct_embed_dim % 128 == 0


def test_mlp_replay_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        mr.main([])
