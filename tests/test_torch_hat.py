"""HAT in the port's training path (``models.hat``) against the plain
reference of the benchmark (``benchmark/reference/hat.py``) on seeded
random weights at small sizes on the CPU: the forward and every leaf's
gradient, the overlapping cross-attention against a loop over windows with
explicitly zero-padded keys, the tables at window 16, the CAB's backward
against autograd's, one ``predef_filters`` train step with Adam, the
state-dict keys and the parameter count at the published widths,
``cli.train`` with a HAT params file, the options it refuses and the
serving entry points' refusal."""

import json
import os

import pytest
import torch

from benchmark.reference import hat as ref
from benchmark.reference import swinir as ref_swinir
from benchmark.reference.hat_weights import init_state
from sifsr_tpu_torch.cli import train as cli_train
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.config import HATConfig, TrainConfig, load_params_json
from sifsr_tpu_torch.data.datasets import prepare_batch
from sifsr_tpu_torch.models.hat import HAT, overlap_position_index
from sifsr_tpu_torch.models.swinir import shift_mask
from sifsr_tpu_torch.train.checkpoint import load_final
from sifsr_tpu_torch.train.loop import build_model
from sifsr_tpu_torch.train.state import create_train_state
from sifsr_tpu_torch.train.step import make_train_step
from test_torch_swinir import STATS, _argv, _batch, _write_pairs

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)

# windows of 4 (6² key windows) with two groups of two HABs, so that every
# group has a shifted HAB and its OCAB sees border and inner windows; and
# the published window of 16 (24² key windows) and head width 30
CASES = {
    "w4_16x16": (dict(upscale=4, in_chans=32, embed_dim=24, depths=[2, 2], num_heads=[2, 3],
                      window_size=4, compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
                      overlap_ratio=0.5, mlp_ratio=2.0, num_feat=8), 16),
    "head30_w16": (dict(upscale=4, in_chans=32, embed_dim=60, depths=[2], num_heads=[2],
                        window_size=16, compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
                        overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16), 48),
}
TINY = CASES["w4_16x16"][0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_swinir.py: Adam's first
    step turns summation-order noise into whole steps where a gradient is
    near its eps, and the order depends on the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(p):
    return HAT(**{k: tuple(v) if isinstance(v, list) else v for k, v in p.items()})


def _loaded(p, seed=1):
    sd = init_state(torch.Generator().manual_seed(seed), "cpu", p)
    model = _model(p)
    model.load_state_dict(sd, strict=True)
    return model, sd


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_the_reference(case):
    """Same weights, same input, same output gradient. Forward: 1e-6 of the
    output's largest value, float32 rounding of the same products in
    another association (the program adds the bias in place, runs the
    projections through ``nn.Linear`` and the CAB's pool through
    ``adaptive_avg_pool2d``). Gradients: 1e-5 of each leaf's largest
    element, for the attentions' hand-written backward and the unfold's
    scatter-add, whose sums run in another order than autograd's."""
    p, lr = CASES[case]
    model, sd = _loaded(p)
    assert [n for n, _ in model.named_parameters()] == [n for n, _, _ in ref.param_plan(p)]
    x = torch.randn(2, 4 * lr, 4 * lr, 2, generator=torch.Generator().manual_seed(2))
    xp = x.clone().requires_grad_(True)
    xr = x.permute(0, 3, 1, 2).clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    y = model(xp).permute(0, 3, 1, 2)
    yr = ref.forward(leaves, xr, p)
    assert y.shape == yr.shape == (2, 1, 4 * lr, 4 * lr)
    assert (y - yr).abs().max() <= 1e-6 * yr.abs().max()
    g = torch.randn(yr.shape, generator=torch.Generator().manual_seed(3))
    (y * g).sum().backward()
    (yr * g).sum().backward()
    for name, w in model.named_parameters():
        want = leaves[name].grad
        assert (w.grad - want).abs().max() <= 1e-5 * want.abs().max(), name
    assert (xp.grad.permute(0, 3, 1, 2) - xr.grad).abs().max() <= 1e-5 * xr.grad.abs().max()


@pytest.mark.parametrize("window,hw", [(4, (12, 16)), (16, (48, 48))])
def test_ocab_matches_a_loop_over_windows_with_zero_padded_keys(window, hw):
    """One OCAB's attention window by window: each query window against the
    overlapping window around it, cut from k and v after zeros are written
    around the map, so that the border windows (all but the inner ones)
    see zero keys and values. Within 1e-5 of the largest output: the
    program runs batched products, the loop one window at a time."""
    p = {**TINY, "window_size": window, "embed_dim": 12, "num_heads": [2]}
    model = _model({**p, "depths": [1]})
    model.init_parameters(torch.Generator().manual_seed(4))
    ocab = model.layers[0].residual_group.overlap_attn
    h, w = hw
    t = torch.randn(2, h * w, 12, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = ocab(t, hw)
        ow, heads, c = ocab.overlap, 2, 12
        pad, d = (ow - window) // 2, c // heads
        qkv = ocab.qkv(ocab.norm1(t)).view(2, h, w, 3, c)
        kp = torch.zeros(2, h + 2 * pad, w + 2 * pad, 2, c)
        kp[:, pad:pad + h, pad:pad + w] = qkv[..., 1:, :]
        a, b = torch.arange(window * window)[:, None], torch.arange(ow * ow)[None, :]
        dy, dx = b // ow - a // window, b % ow - a % window
        rows = (dy + window - ow + 1) * (window + ow - 1) + dx + window - ow + 1
        bias = ocab.relative_position_bias_table[rows % (window + ow - 1) ** 2]
        out = torch.empty(2, h, w, c)
        for iy in range(h // window):
            for ix in range(w // window):
                q = qkv[:, iy * window:(iy + 1) * window, ix * window:(ix + 1) * window, 0]
                kv = kp[:, iy * window:iy * window + ow, ix * window:ix * window + ow]
                q = q.reshape(2, -1, heads, d).transpose(1, 2) * d ** -0.5
                k, v = (kv[..., j, :].reshape(2, -1, heads, d).transpose(1, 2) for j in (0, 1))
                s = q @ k.transpose(-2, -1) + bias.permute(2, 0, 1)
                y = (s.softmax(-1) @ v).transpose(1, 2).reshape(2, window, window, c)
                out[:, iy * window:(iy + 1) * window, ix * window:(ix + 1) * window] = y
        t1 = t + ocab.proj(out.reshape(2, h * w, c))
        want = t1 + ocab.mlp(ocab.norm2(t1))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (48, 80)])
def test_tables_at_window_16(hw):
    """The HABs' shift mask at window 16 (shift 8), the mask the network
    caches, and the OCAB's 24² index, each against the reference's own
    construction; the index reaches every one of the table's 39² rows."""
    mask = shift_mask(*hw, 16, 8)
    assert torch.equal(mask, ref_swinir.region_mask(*hw, 16, 8))
    assert torch.equal(HAT(embed_dim=12, depths=(2,), num_heads=(2,), squeeze_factor=6,
                           num_feat=8)._mask(*hw, "cpu"), mask)
    index = overlap_position_index(16, 24)
    assert torch.equal(index, ref.oca_index(16, 24))
    assert sorted(index.unique().tolist()) == list(range(39 * 39))


def test_cab_backward_is_autograd_bit_for_bit():
    """The CAB as one node of the outer graph (its backward in one
    ``hat.cab`` range) gives the input's and every parameter's gradient bit
    for bit as autograd over the same branch does."""
    model, _ = _loaded(TINY)
    cab = model.layers[0].residual_group.blocks[1].conv_block
    u = torch.randn(2, 16, 16, 24, generator=torch.Generator().manual_seed(6))
    g = torch.randn(2, 16, 16, 24, generator=torch.Generator().manual_seed(7))
    grads = []
    for branch in (cab, cab._branch):
        x = u.clone().requires_grad_(True)
        out = branch(x)
        params = list(cab.parameters())
        grads.append((out.detach(), *torch.autograd.grad(out, [x, *params], g)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_train_step_matches_the_reference():
    """One ``make_train_step`` ``predef_filters`` step against the
    reference's, with SwinIR's tolerances (tests/test_torch_swinir.py): the
    loss to 1e-6 relative, Adam's first moment over 1 - beta1 to 1e-4 of
    each leaf's largest element, the update to 1e-3 of the learning rate
    where the reference's gradient exceeds ten times Adam's eps. That
    leaves out nearly all of the bias tables and the CAB's 1x1s and about
    half of its 3x3s (the branch enters at 0.01) at these widths, and about
    a seventh of the other leaves' elements."""
    p, lr = TINY, 1e-3
    tc = {"learning_rate": lr, "alpha": 0.99, "gamma": -0.5,
          "adam": {"betas": [0.9, 0.999], "eps": 1e-8}}
    model, sd0 = _loaded(p, seed=4)
    state = create_train_state(model, lr, variables={k: v.clone() for k, v in sd0.items()},
                               device="cpu")
    step = make_train_step(model, "predef_filters", tc["alpha"], tc["gamma"], STATS["mean_lst"],
                           STATS["std_lst"])
    batch = _batch(2, 16, 5)
    _, metrics = step(state, prepare_batch(batch, "cpu"))
    losses, grad1, after = ref.train_steps(sd0, [batch], p, tc, STATS, "cpu")
    assert abs(float(metrics["loss"]) - losses[0]) <= 1e-6 * abs(losses[0])
    kept = total = 0
    for name, w in state.model.named_parameters():
        got = state.optimizer.state[w]["exp_avg"] / (1 - 0.9)
        assert (got - grad1[name]).abs().max() <= 1e-4 * grad1[name].abs().max(), name
        moved = grad1[name].abs() > 1e-7
        assert ((w.detach() - after[name])[moved].abs() <= 1e-3 * lr).all(), name
        if "conv_block" not in name and "bias_table" not in name:
            kept += int(moved.sum())
            total += moved.numel()
    assert kept >= 0.85 * total, (kept, total)


# hat_arch.py's names of one group's parameters, written out from its
# modules: HAB (norm1, attn, conv_block.cab = [conv, GELU, conv,
# ChannelAttention.attention = [pool, conv, ReLU, conv, Sigmoid]], norm2,
# mlp), then AttenBlocks.overlap_attn (OCAB: its table, then norm1, qkv,
# proj, norm2, mlp), then RHAG.conv
HAB_KEYS = ["norm1.weight", "norm1.bias", "attn.relative_position_bias_table",
            "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
            "conv_block.cab.0.weight", "conv_block.cab.0.bias", "conv_block.cab.2.weight",
            "conv_block.cab.2.bias", "conv_block.cab.3.attention.1.weight",
            "conv_block.cab.3.attention.1.bias", "conv_block.cab.3.attention.3.weight",
            "conv_block.cab.3.attention.3.bias", "norm2.weight", "norm2.bias",
            "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"]
OCAB_KEYS = ["relative_position_bias_table", "norm1.weight", "norm1.bias", "qkv.weight",
             "qkv.bias", "proj.weight", "proj.bias", "norm2.weight", "norm2.bias",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"]
HEAD = ["conv_first.weight", "conv_first.bias", "patch_embed.norm.weight",
        "patch_embed.norm.bias"]
TAIL = ["norm.weight", "norm.bias", "conv_after_body.weight", "conv_after_body.bias",
        "conv_before_upsample.0.weight", "conv_before_upsample.0.bias", "upsample.0.weight",
        "upsample.0.bias", "upsample.2.weight", "upsample.2.bias", "conv_last.weight",
        "conv_last.bias"]


def test_state_dict_keys_follow_hat_arch():
    model = _model(TINY)
    want = list(HEAD)
    for i, depth in enumerate(TINY["depths"]):
        g = f"layers.{i}.residual_group"
        want += [f"{g}.blocks.{j}.{k}" for j in range(depth) for k in HAB_KEYS]
        want += [f"{g}.overlap_attn.{k}" for k in OCAB_KEYS]
        want += [f"layers.{i}.conv.weight", f"layers.{i}.conv.bias"]
    want += TAIL
    assert list(model.state_dict()) == want


def test_parameter_count_at_the_published_widths():
    """HAT_SRx4 with RGB in and out: 20,772,507 parameters (the paper's
    20.8 M), the port's one output channel and two more of ``conv_last``
    (64 x 3 x 3 weights and a bias each); this system's 32 input channels
    and one output channel 20,818,333."""
    rgb = sum(w.numel() for w in HAT(in_chans=3).parameters()) + 2 * (64 * 9 + 1)
    assert rgb == 20_772_507 and round(rgb / 1e6, 1) == 20.8
    model = build_model(load_params_json(os.path.join(ROOT, "paramsHAT.json")))
    assert isinstance(model, HAT)
    assert sum(w.numel() for w in model.parameters()) == 20_818_333


def test_seeded_init_follows_hat_rule():
    """``create_train_state`` draws HAT's weights from the seed: the same
    seed the same weights, another others; both bias tables and every Linear
    weight a normal of std 0.02 (within 2 %), Linear biases 0, LayerNorm
    1 / 0, each conv (the CAB's 1x1s included) within +-1/sqrt(fan_in)."""
    p = {**TINY, "embed_dim": 60, "squeeze_factor": 30}

    def fresh(seed):
        model = _model(p)
        create_train_state(model, 2e-4, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
        return model

    a, b, c = fresh(7).state_dict(), fresh(7).state_dict(), fresh(8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    tables = [v for k, v in a.items() if k.endswith("bias_table")]
    assert len(tables) == 2 * 2 + 2
    normal = torch.cat([v.flatten() for k, v in a.items()
                        if k.endswith("bias_table") or (k.endswith(".weight") and v.ndim == 2)])
    assert abs(float(normal.std()) / 0.02 - 1) < 0.02
    for m in fresh(7).modules():
        if isinstance(m, torch.nn.Linear):
            assert not m.bias.any()
        elif isinstance(m, torch.nn.LayerNorm):
            assert torch.all(m.weight == 1) and not m.bias.any()
        elif isinstance(m, torch.nn.Conv2d):
            bound = 1 / m.weight[0].numel() ** 0.5
            assert m.weight.abs().max() <= bound and m.bias.abs().max() <= bound


def _hat_params(tmp_path, n_epochs):
    with open(os.path.join(ROOT, "paramsHAT.json")) as f:
        params = json.load(f)
    params["hyperparameters"].update(batch_size=2, n_epochs=n_epochs)
    params["hat_parameters"].update(embed_dim=12, depths=[2], num_heads=[2], window_size=8,
                                    squeeze_factor=6, num_feat=8)
    params["save_parameters"]["save_path"] = str(tmp_path / "run")
    path = tmp_path / f"params_{n_epochs}.json"
    path.write_text(json.dumps(params))
    return path


def test_cli_train_trains_and_saves_hat(tmp_path, capsys):
    """``cli.train --params`` with a HAT params file: one epoch on a GeoTIFF
    manifest through ``train_loop``, and the final files, which load back
    into ``models.hat.HAT``."""
    _write_pairs(tmp_path)
    cli_train.main(_argv(tmp_path, _hat_params(tmp_path, 1)))
    out = capsys.readouterr().out
    assert "train=2 val=1" in out and "epoch 1/1" in out
    sd = load_final(str(tmp_path / "run"), "hat")
    model = HAT(embed_dim=12, depths=(2,), num_heads=(2,), window_size=8, squeeze_factor=6,
                num_feat=8)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("flags", [["--remat"], ["--pad-impl", "fused"]])
def test_cli_train_refuses_modelb2_options_for_hat(tmp_path, flags):
    params = _hat_params(tmp_path, 1)
    with pytest.raises(ValueError, match="ModelB_2 option: HAT"):
        cli_train.main(["--params", str(params), "--csv", "absent.csv", "--device", "cpu",
                        *flags])


def test_params_file_gives_hat_and_refuses_what_the_port_does_not_build(tmp_path):
    assert load_params_json(os.path.join(ROOT, "paramsHAT.json")).model == HATConfig()
    with pytest.raises(ValueError, match="bf16"):
        build_model(TrainConfig(model=HATConfig(), precision="bf16"))
    params = json.loads(open(os.path.join(ROOT, "paramsHAT.json")).read())
    params["hat_parameters"]["resi_connection"] = "3conv"
    path = tmp_path / "p.json"
    path.write_text(json.dumps(params))
    with pytest.raises(ValueError, match="hat_parameters.resi_connection"):
        load_params_json(str(path))


@pytest.mark.parametrize("how", ["params_file", "state_dict"])
def test_serving_entry_points_refuse_hat(tmp_path, how):
    """``cli.predict``, ``cli.serve`` and ``cli.model_perf`` load through
    ``load_variables``, which refuses a HAT run by name: by its params file,
    or by its state dict alone."""
    from sifsr_tpu_torch.cli import model_perf, predict, serve

    model = HAT(embed_dim=12, depths=(2,), num_heads=(2,), window_size=8, squeeze_factor=6,
                num_feat=8)
    name = "hat" if how == "params_file" else "modelB"
    torch.save(model.state_dict(), tmp_path / f"{name}_state_dict.pt")
    if how == "params_file":
        (tmp_path / f"{name}_train_params.json").write_text(json.dumps({"model": "HAT"}))
    stats = tmp_path / "statistics.json"
    stats.write_text(json.dumps(STATS))
    refusal = "is a HAT model: HAT has no serving step"
    with pytest.raises(ValueError, match=refusal):
        load_variables(str(tmp_path), name)
    with pytest.raises(ValueError, match=refusal):
        predict.main(["--MOD21A1D_file_path", "absent.tif", "--MOD09GQ_file_path", "absent.tif",
                      "--model_dir", str(tmp_path), "--model_name", name, "--statistics",
                      str(stats), "--device", "cpu"])
    with pytest.raises(ValueError, match=refusal):
        serve.main(["--watch", str(tmp_path / "spool"), "--once", "--model_dir", str(tmp_path),
                    "--model_name", name, "--statistics", str(stats), "--device", "cpu"])
    if name == "modelB":
        with pytest.raises(ValueError, match=refusal):
            model_perf.main(["--model-dir", str(tmp_path), "--statistics", str(stats),
                             "--dataset", str(tmp_path), "--device", "cpu"])

