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


class _Pick(torch.nn.Module):
    """Twice the two largest values of each row (a top-k, as EPRL's)."""

    def forward(self, x):
        return x.topk(2, dim=1).values * 2.0


def _traced_step(x):
    model = torch.nn.Sequential(torch.nn.Identity(), _Pick())
    leaf = torch.tensor(x, requires_grad=True)
    records = []
    with mr.traced(model, records):
        model(leaf).sum().backward()
    return records


def test_traced_steps_that_agree_show_no_divergence():
    row = [[3.0, 2.0, 2.0 + 1e-5, 0.0], [1.0, -1.0, 0.5, 0.25]]
    topk = torch.Tensor.topk
    dv = mr.first_divergence(_traced_step(row), _traced_step(row))
    assert torch.Tensor.topk is topk
    assert dv["forward"] is None and dv["backward"] is None
    assert [(k, rows) for k, rows, _, _ in dv["topk"]] == [(0, 0)]


def test_a_near_tie_in_topk_is_named():
    """Two values 1e-5 apart trade places between the two steps: the forward
    agrees (the picked values are the same), the gradient reaching the
    top-k's input does not, and the top-k's rows and margin say why."""
    card = _traced_step([[3.0, 2.0, 2.0 + 1e-5, 0.0]])
    cpu = _traced_step([[3.0, 2.0 + 1e-5, 2.0, 0.0]])
    dv = mr.first_divergence(card, cpu)
    assert dv["forward"] is None
    name, call, err, before = dv["backward"]
    assert (name, call) == ("0[0]", 0) and err > 0.5 and before == 0.0
    assert dv["largest"] == dv["backward"][:3]
    (k, rows, margin_there, margin), = dv["topk"]
    assert (k, rows) == (0, 1) and 0 < margin_there <= 2e-5 and margin == margin_there


class _Kink(torch.nn.Module):
    """A Dense layer, then a ReLU outside any module (as DILR's attention)."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(3, 3)
        with torch.no_grad():
            self.dense.weight.copy_(torch.eye(3))
            self.dense.bias.zero_()

    def forward(self, x):
        return (torch.relu(self.dense(x)) * torch.tensor([1.0, 5.0, 1.0])).sum()


def _kink_step(x):
    model = _Kink()
    records = []
    with mr.traced(model, records):
        model(torch.tensor(x, requires_grad=True)).backward()
    return records


def test_a_relu_kink_is_named_with_its_sign_flips():
    """A pre-activation 1e-7 either side of 0: the forward agrees, the
    gradient at the Dense layer's output does not, and the one element of
    another sign is counted."""
    dv = mr.first_divergence(_kink_step([1.0, 1e-7, 2.0]), _kink_step([1.0, -1e-7, 2.0]))
    assert dv["forward"] is None
    assert dv["backward"][:2] == ("dense[0]", 0) and dv["backward"][2] > 0.5
    count, largest = dv["kinks"]
    assert count == 1 and largest == pytest.approx(1e-7)


def test_traced_records_are_copies():
    """A recorded CPU tensor keeps its value when the step later changes the
    tensor in place (as Adam changes a parameter that a module returns)."""
    model = torch.nn.Sequential(torch.nn.Identity())
    x = torch.ones(3)
    records = []
    with mr.traced(model, records):
        model(x)
    x.add_(1.0)
    assert torch.equal(records[0][4][0], torch.ones(3))
