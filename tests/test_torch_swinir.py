"""SwinIR in the port's training path (``models.swinir``) against the plain
reference of the benchmark (``benchmark/reference/swinir.py``) on seeded
random weights at small sizes on the CPU: the forward and every leaf's
gradient, the window tables, one ``predef_filters`` train step with Adam,
``cli.train`` with a SwinIR params file (train, save, resume), the options
it refuses, the seeded initialisation, the serving entry points' refusal
and the attention's spans and counters."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import swinir as ref
from benchmark.reference.swinir_weights import init_state
from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.cli import train as cli_train
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.config import SwinIRConfig, TrainConfig, load_params_json
from sifsr_tpu_torch.data.datasets import prepare_batch
from sifsr_tpu_torch.geo.tiff import write_geotiff
from sifsr_tpu_torch.models.swinir import SwinIR, relative_position_index, shift_mask
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train.checkpoint import load_final
from sifsr_tpu_torch.train.loop import build_model
from sifsr_tpu_torch.train.state import create_train_state
from sifsr_tpu_torch.train.step import make_train_step

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
STATS = dict(maxi=330.0, mini=260.0, mean_lst=295.0, std_lst=10.0, mean_ndvi=0.3,
             std_ndvi=0.25)

# head width 30 as published (60 over 2 heads), windows of 8 on a 16² LR
# grid; and windows of 4 with two groups, so that every group has a shifted
# layer, its region mask and the bias gather on 16 windows
CASES = {
    "head30_w8": dict(upscale=4, in_chans=32, embed_dim=60, depths=[2], num_heads=[2],
                      window_size=8, mlp_ratio=2.0, num_feat=16),
    "w4_16x16": dict(upscale=4, in_chans=32, embed_dim=12, depths=[2, 2], num_heads=[2, 3],
                     window_size=4, mlp_ratio=2.0, num_feat=8),
}
TINY = CASES["w4_16x16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train_loop.py: Adam's first
    step turns summation-order noise into whole steps where a gradient is
    near its eps, and the order depends on the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(p):
    return SwinIR(upscale=p["upscale"], in_chans=p["in_chans"], embed_dim=p["embed_dim"],
                  depths=p["depths"], num_heads=p["num_heads"], window_size=p["window_size"],
                  mlp_ratio=p["mlp_ratio"], num_feat=p["num_feat"])


def _loaded(p, seed=1):
    sd = init_state(torch.Generator().manual_seed(seed), "cpu", p)
    model = _model(p)
    model.load_state_dict(sd, strict=True)
    return model, sd


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_the_reference(case):
    """Same weights, same input, same output gradient. Forward: 1e-6 of the
    output's largest value, float32 rounding of the same products in
    another association (the program adds the bias in place and runs the
    projections through ``nn.Linear``). Gradients: 1e-5 of each leaf's
    largest element, for the attention's hand-written backward, whose sums
    run in another order than autograd's."""
    p = CASES[case]
    model, sd = _loaded(p)
    assert [n for n, _ in model.named_parameters()] == [n for n, _, _ in ref.param_plan(p)]
    x = torch.randn(2, 64, 64, 2, generator=torch.Generator().manual_seed(2))
    xp = x.clone().requires_grad_(True)
    xr = x.permute(0, 3, 1, 2).clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    y = model(xp).permute(0, 3, 1, 2)
    yr = ref.forward(leaves, xr, p)
    assert y.shape == yr.shape == (2, 1, 64, 64)
    assert (y - yr).abs().max() <= 1e-6 * yr.abs().max()
    g = torch.randn(yr.shape, generator=torch.Generator().manual_seed(3))
    (y * g).sum().backward()
    (yr * g).sum().backward()
    for name, w in model.named_parameters():
        want = leaves[name].grad
        assert (w.grad - want).abs().max() <= 1e-5 * want.abs().max(), name
    assert (xp.grad.permute(0, 3, 1, 2) - xr.grad).abs().max() <= 1e-5 * xr.grad.abs().max()


@pytest.mark.parametrize("window,hw", [(8, (16, 16)), (4, (16, 16)), (4, (8, 12))])
def test_window_tables_match_the_reference(window, hw):
    """The bias-table index and the shifted layers' region mask, each built
    its own way in the program and in the reference."""
    assert torch.equal(relative_position_index(window), ref.rel_index(window))
    mask = shift_mask(*hw, window, window // 2)
    assert torch.equal(mask, ref.region_mask(*hw, window, window // 2))
    assert set(mask.unique().tolist()) == {0.0, -100.0}


def _batch(n, lr, seed):
    g = torch.Generator().manual_seed(seed)
    ndvi = torch.rand(n, 4 * lr, 4 * lr, 1, generator=g)
    lst = ndvi[:, ::4, ::4] * -0.8 + 0.1 * torch.randn(n, lr, lr, 1, generator=g)
    return {"lst": lst.numpy(), "ndvi": ((ndvi - 0.5) * 2.0).numpy()}


def test_train_step_matches_the_reference():
    """One ``make_train_step`` ``predef_filters`` step (loss, gradients and
    Adam's update) against the reference's step. The loss agrees to 1e-6
    relative; the first gradient (Adam's first moment over 1 - beta1) to
    1e-4 of each leaf's largest element, as in the forward/backward test
    with the losses' own chains on top; the update to 1e-6 absolute, a
    thousandth of the learning rate, since Adam's first step moves each
    element by about the rate. The update is compared where the reference's
    gradient exceeds 1e-7, ten times Adam's eps: its first step,
    lr g / (|g| + eps), turns with round-off only where |g| is near eps. At
    these widths SwinIR's 0.02-std init leaves about a tenth of the elements
    (the bias tables' all) below that."""
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
        kept += int(moved.sum())
        total += moved.numel()
    assert kept >= 0.85 * total, (kept, total)


def _write_pairs(tmp_path, n=3):
    rng = np.random.default_rng(0)
    (tmp_path / "pairs").mkdir()
    rows = []
    for i in range(n):
        ndvi = (0.3 + 0.2 * rng.random((256, 256))).astype(np.float32)
        lst = (300.0 - 20.0 * ndvi[::4, ::4] + 0.05 * rng.normal(size=(64, 64))).astype(np.float32)
        lst_p = tmp_path / "pairs" / f"MOD21A1D_day.A2020{100 + i:03d}.{i}.tif"
        ndvi_p = tmp_path / "pairs" / f"MOD09GQ.A2020{100 + i:03d}.{i}.tif"
        write_geotiff(str(lst_p), lst)
        write_geotiff(str(ndvi_p), ndvi)
        rows.append({"LST": str(lst_p), "NDVI": str(ndvi_p), "split": "Train" if i < 2 else "Val"})
    with open(tmp_path / "ModisDatasetB.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["LST", "NDVI", "split"])
        w.writeheader()
        w.writerows(rows)
    (tmp_path / "statistics.json").write_text(json.dumps(STATS))


def _swinir_params(tmp_path, n_epochs, widths=None):
    with open(os.path.join(ROOT, "paramsSwinIR.json")) as f:
        params = json.load(f)
    params["hyperparameters"].update(batch_size=2, n_epochs=n_epochs)
    params["swinir_parameters"].update(
        widths or dict(embed_dim=12, depths=[2], num_heads=[2], num_feat=8))
    params["save_parameters"]["save_path"] = str(tmp_path / "run")
    path = tmp_path / f"params_{n_epochs}.json"
    path.write_text(json.dumps(params))
    return path


def _argv(tmp_path, params, *extra):
    return ["--params", str(params), "--statistics", str(tmp_path / "statistics.json"),
            "--csv", str(tmp_path / "ModisDatasetB.csv"), "--device", "cpu", *extra]


def test_cli_train_trains_saves_and_resumes_swinir(tmp_path, capsys):
    """``cli.train --params`` with a SwinIR params file: one epoch on a
    GeoTIFF manifest, the final files, then a resume to a second epoch from
    the epoch checkpoint."""
    _write_pairs(tmp_path)
    cli_train.main(_argv(tmp_path, _swinir_params(tmp_path, 1), "--resume"))
    out = capsys.readouterr().out
    assert "train=2 val=1" in out and "epoch 1/1" in out
    save = tmp_path / "run"
    assert {"swinir_state_dict.pt", "swinir_lossdata.pkl", "swinir_train_params.json"} <= set(
        os.listdir(save))
    sd = load_final(str(save), "swinir")
    model = SwinIR(embed_dim=12, depths=(2,), num_heads=(2,), num_feat=8)
    model.load_state_dict(sd, strict=True)
    cli_train.main(_argv(tmp_path, _swinir_params(tmp_path, 2), "--resume"))
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "epoch 2/2" in out
    resumed = load_final(str(save), "swinir")
    assert set(resumed) == set(sd)
    assert any(not torch.equal(resumed[k], sd[k]) for k in sd)


@pytest.mark.parametrize("flags", [["--remat"], ["--pad-impl", "fused"]])
def test_cli_train_refuses_modelb2_options_for_swinir(tmp_path, flags):
    """``--remat`` and ``--pad-impl fused`` are ModelB_2's: SwinIR raises
    before any data is read."""
    params = _swinir_params(tmp_path, 1)
    with pytest.raises(ValueError, match="ModelB_2 option"):
        cli_train.main(["--params", str(params), "--csv", "absent.csv", "--device", "cpu",
                        *flags])


def test_build_model_follows_the_params_file():
    config = load_params_json(os.path.join(ROOT, "paramsSwinIR.json"))
    assert config.model == SwinIRConfig()
    model = build_model(config)
    assert isinstance(model, SwinIR)
    assert sum(w.numel() for w in model.parameters()) == 11_946_025
    assert isinstance(build_model(load_params_json(os.path.join(ROOT, "paramsB.json"))), ModelB2)
    with pytest.raises(ValueError, match="bf16"):
        build_model(TrainConfig(model=SwinIRConfig(), precision="bf16"))


def test_params_file_refuses_what_the_port_does_not_build(tmp_path):
    params = json.loads(open(os.path.join(ROOT, "paramsSwinIR.json")).read())
    params["swinir_parameters"]["upsampler"] = "nearest+conv"
    path = tmp_path / "p.json"
    path.write_text(json.dumps(params))
    with pytest.raises(ValueError, match="upsampler"):
        load_params_json(str(path))


def test_seeded_init_is_reproducible_and_follows_swinir_rule():
    """SwinIR-M at its published widths, initialised through
    ``create_train_state``: the same seed gives the same weights, another
    seed others; Linear weights and bias tables have standard deviation
    0.02 (within 1 %, over 9.4 M draws), Linear biases are zero, LayerNorm
    1 / 0, and each conv lies within +-1/sqrt(fan_in) with the uniform
    law's standard deviation bound/sqrt(3) (within 2 % over its weight)."""
    def fresh(seed):
        model = SwinIR()
        create_train_state(model, 2e-4, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
        return model

    a, b, c = fresh(7).state_dict(), fresh(7).state_dict(), fresh(8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    normal = torch.cat([v.flatten() for k, v in a.items()
                        if k.endswith("bias_table") or (k.endswith(".weight") and v.ndim == 2)])
    assert normal.numel() > 9_000_000
    assert abs(float(normal.std()) - 0.02) < 2e-4 and abs(float(normal.mean())) < 1e-4
    model = fresh(7)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            assert not m.bias.any()
        elif isinstance(m, torch.nn.LayerNorm):
            assert torch.all(m.weight == 1) and not m.bias.any()
        elif isinstance(m, torch.nn.Conv2d):
            bound = 1 / m.weight[0].numel() ** 0.5
            assert m.weight.abs().max() <= bound and m.bias.abs().max() <= bound
            if m.weight.numel() > 100_000:
                assert abs(float(m.weight.detach().std()) / (bound / 3 ** 0.5) - 1) < 0.02


@pytest.mark.parametrize("how", ["params_file", "state_dict"])
def test_serving_entry_points_refuse_swinir(tmp_path, how):
    """``cli.predict``, ``cli.serve`` and ``cli.model_perf`` all load through
    ``load_variables``, which refuses a SwinIR run: by its params file, or
    by its state dict alone. ``cli.model_perf`` asks for ``modelB``: a run
    saved under another name has no weights there, which it says."""
    from sifsr_tpu_torch.cli import model_perf, predict, serve

    model = SwinIR(embed_dim=12, depths=(2,), num_heads=(2,), num_feat=8)
    name = "swinir" if how == "params_file" else "modelB"
    torch.save(model.state_dict(), tmp_path / f"{name}_state_dict.pt")
    if how == "params_file":
        (tmp_path / f"{name}_train_params.json").write_text(json.dumps({"model": "SwinIR"}))
    stats = tmp_path / "statistics.json"
    stats.write_text(json.dumps(STATS))
    with pytest.raises(ValueError, match="SwinIR has no serving step"):
        load_variables(str(tmp_path), name)
    with pytest.raises(ValueError, match="SwinIR has no serving step"):
        predict.main(["--MOD21A1D_file_path", "absent.tif", "--MOD09GQ_file_path", "absent.tif",
                      "--model_dir", str(tmp_path), "--model_name", name, "--statistics",
                      str(stats), "--device", "cpu"])
    with pytest.raises(ValueError, match="SwinIR has no serving step"):
        serve.main(["--watch", str(tmp_path / "spool"), "--once", "--model_dir", str(tmp_path),
                    "--model_name", name, "--statistics", str(stats), "--device", "cpu"])
    refusal = ((ValueError, "SwinIR has no serving step") if name == "modelB"
               else (FileNotFoundError, "no weights under"))
    with pytest.raises(refusal[0], match=refusal[1]):
        model_perf.main(["--model-dir", str(tmp_path), "--statistics", str(stats),
                         "--dataset", str(tmp_path), "--device", "cpu"])


def test_attention_spans_and_counters():
    """Under tracing a ``train_step`` root holds one ``swin.attention`` span
    per Swin layer forward and one backward, and the counters ``tokens``
    (LR tokens) and ``swin_windows`` (windows x Swin layers); under a
    profiler the backward's ranges are on its timeline too."""
    model, _ = _loaded(TINY)
    x = torch.randn(2, 64, 64, 2)
    layers = sum(TINY["depths"])
    tracing.enable()
    try:
        tracing.clear()
        with tracing.root("train_step"):
            model(x).sum().backward()
        (rec,) = tracing.records()
    finally:
        tracing.disable()
        tracing.clear()
    names = [s["name"] for s in rec["spans"]]
    assert names == ["swin.attention"] * (2 * layers)
    assert rec["counts"] == {"tokens": 2 * 16 * 16, "swin_windows": 2 * 16 * layers}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x).sum().backward()
    got = [e for e in prof.events() if e.name == "sifsr.swin.attention"]
    assert len(got) == 2 * layers
    tracing.clear()


class _PackedWindowAttentionFn(torch.autograd.Function):
    """``WindowAttentionFn`` for one packed qkv alone, under a fixed span:
    the function SwinIR's numerics were set by, before it also took queries
    against keys and values of another count."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads: int, scale: float):
        b_, n, c3 = qkv.shape
        d = c3 // (3 * heads)
        q, k, v = qkv.view(b_, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q = q * scale
        attn = torch.matmul(q, k.transpose(-2, -1))
        attn += bias
        if mask is not None:
            nw = mask.shape[0]
            attn.view(b_ // nw, nw, heads, n, n).add_(mask[None, :, None])
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v)
        ctx.save_for_backward(qkv, attn)
        ctx.heads, ctx.scale = heads, scale
        return out.transpose(1, 2).reshape(b_, n, c3 // 3)

    @staticmethod
    def backward(ctx, dout):
        qkv, attn = ctx.saved_tensors
        heads, scale = ctx.heads, ctx.scale
        b_, n, c3 = qkv.shape
        d = c3 // (3 * heads)
        q, k, v = qkv.view(b_, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        do = dout.reshape(b_, n, heads, d).transpose(1, 2)
        dqkv = qkv.new_empty(b_, n, 3, heads, d)
        dq, dk, dv = dqkv.permute(2, 0, 3, 1, 4)
        dv.copy_(torch.matmul(attn.transpose(-2, -1), do))
        dp = torch.matmul(do, v.transpose(-2, -1))
        ds = attn * (dp - (dp * attn).sum(-1, keepdim=True))
        dbias = ds.sum(0) if ctx.needs_input_grad[1] else None
        dq.copy_(torch.matmul(ds, k)).mul_(scale)
        dk.copy_(torch.matmul(ds.transpose(-2, -1), q * scale))
        return dqkv.view(b_, n, c3), dbias, None, None, None


def _packed_attention_forward(self, x, mask):
    n = x.shape[1]
    bias = self.relative_position_bias_table[self.relative_position_index]
    bias = bias.view(n, n, -1).permute(2, 0, 1)
    return self.proj(_PackedWindowAttentionFn.apply(self.qkv(x), bias, mask, self.heads,
                                                    self.scale))


@pytest.mark.parametrize("case", sorted(CASES))
def test_numerics_equal_the_packed_only_function_bit_for_bit(case, monkeypatch):
    """The attention function that also serves HAT's cross-attention leaves
    SwinIR's forward, every leaf's gradient and the input's gradient bit for
    bit as they were with the packed-only function."""
    from sifsr_tpu_torch.models import swinir

    p = CASES[case]
    x = torch.randn(2, 64, 64, 2, generator=torch.Generator().manual_seed(2))
    g = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(3))
    runs = []
    for packed_only in (False, True):
        if packed_only:
            monkeypatch.setattr(swinir.WindowAttention, "forward", _packed_attention_forward)
        model, _ = _loaded(p)
        xp = x.clone().requires_grad_(True)
        y = model(xp)
        (y * g).sum().backward()
        runs.append([y.detach(), xp.grad] + [w.grad for w in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
