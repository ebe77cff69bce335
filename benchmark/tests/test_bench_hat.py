"""The HAT cell's own parts on the CPU: a whole run at its CPU size that
comes out correct, the control and every planted fault that do not, the
FLOP count against ``torch.utils.flop_counter`` over the plain reference
and at the published widths, the rooflines at the yardstick's least time,
the new readers on records with nothing to read, and a reference that
loads nothing of the program."""

import json
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness import core, hat_yardstick, program_spans, swin_yardstick
from benchmark.reference import hat as ref
from benchmark.reference.hat_weights import init_state
from conftest import ROOT, tiny

CELL = "hat-train"
SEED = 3_000_000_019
SMALL = dict(upscale=4, in_chans=32, embed_dim=24, depths=[2, 2], num_heads=[2, 3],
             window_size=4, compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
             overlap_ratio=0.5, mlp_ratio=2.0, num_feat=8)
NEW = ("hat_train_mfu", "ocab_attention_ms", "ocab_attention_roofline", "channel_attention_ms",
       "channel_attention_roofline")


def test_cell_is_correct_at_its_cpu_size():
    cell = core.load_cell(CELL)
    line, checks = run.execute(cell, SEED, 0.5, False, "cpu", overrides=tiny(cell))
    assert line["correct"], [(c.name, c.value, c.limit) for c in checks]


@pytest.mark.parametrize("what", [{"control": True}, {"fault": "half_batch"},
                                  {"fault": "unchanged"}, {"fault": "ocab_border_masked"}])
def test_control_and_faults_are_not_correct(what):
    cell = core.load_cell(CELL)
    line, checks = run.execute(cell, SEED, 0.5, False, "cpu", overrides=tiny(cell), **what)
    assert not line["correct"], [(c.name, c.value) for c in checks]


def test_the_planted_fault_leaves_the_program_as_it_was():
    from sifsr_tpu_torch.models import hat

    real = hat.WindowAttentionFn
    kind = core.load_part("traffic", "hat_train_batches")
    assert kind.FAULTS[-1] == "ocab_border_masked"
    with kind.border_masked(SMALL, 16, torch.device("cpu")):
        assert hat.WindowAttentionFn is not real
    assert hat.WindowAttentionFn is real


@pytest.mark.parametrize("lr", [16, 12])
def test_flop_count_equals_the_flop_counter(lr):
    """Every product the reference's forward runs, as torch counts them
    (12² pads to the window of 4 as the network pads it)."""
    sd = init_state(torch.Generator().manual_seed(0), "cpu", SMALL)
    x = torch.randn(1, 2, 4 * lr, 4 * lr)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(sd, x, SMALL)
    assert counter.get_total_flops() == hat_yardstick.hat_forward_flops(SMALL, lr, lr)


def test_flop_count_at_the_published_widths():
    """207.99 GFLOP a 64² LR block (PERF.md): 1.94 times SwinIR-M's."""
    p = core.load_cell(CELL).config["hat_parameters"]
    flops = hat_yardstick.hat_forward_flops(p, 64, 64)
    assert flops == 207_994_511_232
    swin = swin_yardstick.swinir_forward_flops(core.load_cell("swinir-train").config[
        "swinir_parameters"], 64, 64)
    assert round(flops / swin, 2) == 1.94


def _record(trace, steps=4, batch=16):
    cell = core.load_cell(CELL)
    p = cell.config["hat_parameters"]
    rec = types.SimpleNamespace(cell=cell, trace=trace, steps=steps, samples=batch * steps,
                                window_s=2.0, hat=p, swinir=p, lr_px=64)
    counts = {"tokens": batch * 4096, "swin_windows": batch * 16 * 36,
              "ocab_windows": batch * 16 * 6, "cab_blocks": batch * 36}
    held = [{"name": "train_step", "counts": counts, "start_ns": 0, "end_ns": 1, "spans": []}
            for _ in range(steps)]
    return rec, held


def test_rooflines_read_100_percent_at_the_least_time(monkeypatch):
    """A record whose ranges took exactly the yardstick's least time a step
    reads 100 % on both rooflines, and the window attention's reader reads
    the HABs' windows of 16² and width 180."""
    p = core.load_cell(CELL).config["hat_parameters"]
    ocab = swin_yardstick.least_seconds(*hat_yardstick.ocab_attention_work(16 * 16 * 6, 16, 24,
                                                                           180))
    cab = swin_yardstick.least_seconds(*hat_yardstick.cab_work(16 * 36, 64, 64, 180, 3))
    hab = swin_yardstick.least_seconds(*swin_yardstick.window_attention_work(16 * 16 * 36, 16,
                                                                             180))
    steps = 4
    trace = {"spans": {"window": 1, "prepare_batch": steps, "train_step": steps},
             "ranges": {"sifsr.hat.ocab_attention": {"count": 48, "device_s": ocab * steps},
                        "sifsr.hat.cab": {"count": 576, "device_s": cab * steps},
                        "sifsr.swin.attention": {"count": 288, "device_s": hab * steps}}}
    rec, held = _record(trace, steps)
    monkeypatch.setattr(program_spans, "_records", lambda: held)
    for name in ("ocab_attention_roofline", "channel_attention_roofline",
                 "window_attention_roofline"):
        assert run.reader(name)(rec) == pytest.approx(100.0), name
    assert run.reader("ocab_attention_ms")(rec) == pytest.approx(ocab * 1e3)
    assert run.reader("channel_attention_ms")(rec) == pytest.approx(cab * 1e3)
    mfu = 100 * 64 * 3 * hat_yardstick.hat_forward_flops(p, 64, 64) / (2.0 * 67e12)
    assert run.reader("hat_train_mfu")(rec) == pytest.approx(mfu)


@pytest.mark.parametrize("trace", [None, {}, {"spans": {"train_step": 4}},
                                   {"spans": {"train_step": 4},
                                    "ranges": {"sifsr.swin.attention": {"count": 288,
                                                                        "device_s": 0.4}}}])
def test_readers_read_nothing_without_their_ranges(monkeypatch, trace):
    """No trace, or a program without HAT's ranges (a version before HAT): the new
    device readers read nothing and raise nothing."""
    rec, held = _record(trace)
    monkeypatch.setattr(program_spans, "_records", lambda: held)
    for name in NEW[1:]:
        assert run.reader(name)(rec) is None, name


def test_mfu_reads_nothing_from_another_cell():
    rec = types.SimpleNamespace(cell=core.load_cell("swinir-train"), window_s=1.0, samples=32)
    assert run.reader("hat_train_mfu")(rec) is None


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.hat, benchmark.reference.hat_weights
from benchmark.harness import core, hat_yardstick
core.load_part("controls", "tf32_hat")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_side_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REFERENCE.format(root=str(ROOT))],
                       capture_output=True, text=True, check=True, cwd=ROOT)
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "sifsr_tpu", "sifsr_tpu_torch"}, names
