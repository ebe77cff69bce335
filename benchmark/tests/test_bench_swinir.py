"""The SwinIR cell's own parts on the CPU: the FLOP count against
``torch.utils.flop_counter`` over the plain reference, the window
attention's bytes and FLOPs from the program's ``swin_windows`` counter,
the attribution of device kernels to the program's ranges, the new
readers on records with nothing to read, the control and the planted
faults at the CPU size, and a reference that loads nothing of the program."""

import json
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness import core, program_spans, swin_yardstick
from benchmark.harness.range_trace import reduce_ranges
from benchmark.reference import swinir as ref
from benchmark.reference.swinir_weights import init_state
from conftest import ROOT, tiny

CELL = "swinir-train"
SMALL = {
    "w4": dict(upscale=4, in_chans=32, embed_dim=12, depths=[2, 2], num_heads=[2, 3],
               window_size=4, mlp_ratio=2.0, num_feat=8),
    "w8_head30": dict(upscale=4, in_chans=32, embed_dim=60, depths=[2], num_heads=[2],
                      window_size=8, mlp_ratio=2.0, num_feat=16),
}


@pytest.mark.parametrize("name,lr", [("w4", 16), ("w4", 12), ("w8_head30", 16)])
def test_flop_count_equals_the_flop_counter(name, lr):
    """Every product the reference's forward runs, as torch counts them
    (12² pads to the window of 4 as the network pads it)."""
    p = SMALL[name]
    sd = init_state(torch.Generator().manual_seed(0), "cpu", p)
    x = torch.randn(1, 2, 4 * lr, 4 * lr)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(sd, x, p)
    assert counter.get_total_flops() == swin_yardstick.swinir_forward_flops(p, lr, lr)


def test_flop_count_at_the_published_widths():
    p = core.load_cell(CELL).config["swinir_parameters"]
    flops = swin_yardstick.swinir_forward_flops(p, 64, 64)
    assert flops == 2 * 4096 * 13_103_856
    assert round(flops / 1e9, 2) == 107.35


def _tiny_counts(p, n=2, lr=16):
    """The program's counters of one forward at a small size."""
    from sifsr_tpu_torch import tracing
    from sifsr_tpu_torch.models.swinir import SwinIR

    model = SwinIR(embed_dim=p["embed_dim"], depths=p["depths"], num_heads=p["num_heads"],
                   window_size=p["window_size"], num_feat=p["num_feat"])
    tracing.enable()
    try:
        tracing.clear()
        with tracing.root("train_step"), torch.no_grad():
            model(torch.zeros(n, 4 * lr, 4 * lr, 2))
        (root,) = tracing.records()
    finally:
        tracing.disable()
        tracing.clear()
    return root


def test_attention_work_follows_the_windows_counter():
    p = SMALL["w4"]
    root = _tiny_counts(p)
    windows = root["counts"]["swin_windows"]
    assert windows == 2 * (16 // 4) ** 2 * sum(p["depths"])
    nbytes, flops = swin_yardstick.window_attention_work(windows, 4, p["embed_dim"])
    tensor = 16 * p["embed_dim"] * 4
    assert nbytes == windows * 12 * tensor
    assert flops == pytest.approx(windows * 3.5 * 4 * 16 * 16 * p["embed_dim"])
    # SwinIR-M, a step of 32: 73,728 window-layers, bytes-bound near 12 ms
    nbytes, flops = swin_yardstick.window_attention_work(32 * 64 * 36, 8, 180)
    assert swin_yardstick.least_seconds(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    assert 0.011 < swin_yardstick.least_seconds(nbytes, flops) < 0.013


def _record(trace, steps=4, windows=73_728):
    cell = core.load_cell(CELL)
    rec = types.SimpleNamespace(cell=cell, trace=trace, steps=steps, samples=32 * steps,
                                window_s=2.0, swinir=cell.config["swinir_parameters"],
                                lr_px=64)
    held = [{"name": "train_step", "counts": {"swin_windows": windows, "tokens": 131072},
             "start_ns": 0, "end_ns": 1, "spans": []} for _ in range(steps)]
    return rec, held


def test_readers_on_a_traced_record(monkeypatch):
    trace = {"spans": {"window": 1, "prepare_batch": 4, "train_step": 4},
             "ranges": {"sifsr.swin.attention": {"count": 288, "device_s": 0.4}}}
    rec, held = _record(trace)
    monkeypatch.setattr(program_spans, "_records", lambda: held)
    ms = run.reader("window_attention_ms")(rec)
    assert ms == pytest.approx(100.0)
    nbytes, flops = swin_yardstick.window_attention_work(73_728, 8, 180)
    want = 100 * swin_yardstick.least_seconds(nbytes, flops) * 1e3 / 100.0
    assert run.reader("window_attention_roofline")(rec) == pytest.approx(want)
    mfu = run.reader("swinir_train_mfu")(rec)
    assert mfu == pytest.approx(100 * 128 * 3 * 107_346_788_352 / (2.0 * 67e12))


@pytest.mark.parametrize("trace", [None, {}, {"spans": {"train_step": 4}},
                                   {"spans": {"train_step": 4},
                                    "ranges": {"sifsr.swin.attention": {"count": 0,
                                                                        "device_s": 0.0}}}])
def test_readers_read_nothing_without_a_trace(monkeypatch, trace):
    """No trace, a program without the attention's ranges (its ranges hold
    no device time) or without tracing: nothing is read."""
    rec, _ = _record(trace)
    monkeypatch.setattr(program_spans, "_records", lambda: None)
    assert run.reader("window_attention_ms")(rec) is None
    assert run.reader("window_attention_roofline")(rec) is None


def test_mfu_reads_nothing_from_another_cell():
    rec = types.SimpleNamespace(cell=core.load_cell("f32-train"), window_s=1.0, samples=32)
    assert run.reader("swinir_train_mfu")(rec) is None


def test_kernels_are_attributed_to_the_ranges_of_their_launching_thread():
    """(row, correlation id, linked id, thread): a kernel counts where the
    host op that launched it started inside a range of the name on the
    op's own thread, and only within the window."""
    def host(name, s, e, corr, tid, ann=False):
        return ((name, False, ann, s, e), corr, 0, tid)

    def kernel(s, e, linked):
        return (("k", True, False, s, e), 0, linked, 7)

    events = [
        host("window", 0, 1000, 0, 1, ann=True),
        host("sifsr.swin.attention", 100, 200, 0, 1, ann=True),     # forward, main thread
        host("sifsr.swin.attention", 300, 400, 0, 2, ann=True),     # backward, autograd thread
        host("aten::bmm", 110, 120, 11, 1),
        host("aten::bmm", 310, 320, 12, 2),
        host("aten::mm", 250, 260, 13, 1),                           # outside the ranges
        host("aten::add", 150, 160, 14, 3),                          # inside in time, other thread
        kernel(500, 600, 11), kernel(600, 650, 12), kernel(650, 700, 13), kernel(700, 720, 14),
        kernel(990, 1100, 12),                                       # cut at the window's end
    ]
    got = reduce_ranges(events, ("sifsr.swin.attention",))["sifsr.swin.attention"]
    assert got["count"] == 2
    assert got["device_s"] == pytest.approx((100 + 50 + 10) * 1e-9)


@pytest.mark.parametrize("what", [{"control": True}, {"fault": "half_batch"},
                                  {"fault": "unchanged"}])
def test_control_and_faults_are_not_correct(what):
    cell = core.load_cell(CELL)
    line, checks = run.execute(cell, 3_000_000_019, 0.5, False, "cpu", overrides=tiny(cell),
                               **what)
    assert not line["correct"], [(c.name, c.value) for c in checks]


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.swinir, benchmark.reference.swinir_weights
from benchmark.harness import core, swin_yardstick, range_trace
core.load_part("controls", "tf32_swinir")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_side_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REFERENCE.format(root=str(ROOT))],
                       capture_output=True, text=True, check=True, cwd=ROOT)
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "sifsr_tpu", "sifsr_tpu_torch"}, names
