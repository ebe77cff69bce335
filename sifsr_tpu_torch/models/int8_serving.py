"""The int8 serving step with its hand-written kernels.

Counterpart of ``sifsr_tpu/models/pallas_serving.py`` ("pallas" would
mislead here). Per batch (N, 64, 64) K LST + (N, 256, 256) NDVI:

1. normalise; cubic x4 of the LST with the int8 quantisation fused into the
   kernel's epilogue (kernel A); NDVI quantised by division;
2. inbloc.conv1 over the separate LST/NDVI int8 planes (kernel D);
3. inbloc.conv2 -> s0 int8, with the mid chain's input (the 2x2 phase mean
   of s0, requantised to db1's input scale) as a fused second output
   (kernel B);
4. the mid chain db1..db3, ub1, ub2, in one of two configurations:
   - ``mid='prow'`` (the default, as in the JAX package): int8 from end to
     end through kernels G-K (``kernels/conv_px.py``): the residual adds,
     the 2x2 pools and the align-corners x2 upsamples fused into the convs'
     epilogues, the skip concats never formed; ub2.conv2 ends in the final
     x2 to the ``up`` scale (kernel K);
   - ``mid='xla'``: the calibrated int8 convs of ``models.quantized``
     (its ``down_block`` and ``up_block``) with float32 tensors between
     them (the JAX ``mid='xla'`` chain), then the align-corners x2
     quantised to the ``up`` scale (kernel A);
5. ub3.conv1 over concat(up, s0) without forming the concat (kernel C),
   ub3.conv2 (kernel B);
6. the outlay, a replicate-pad 16->1 int8 conv with the Kelvin de-normalise
   folded into its dequantise step. The JAX step computes it as a
   zero-padded conv plus exact replicate border strips
   (``pallas_serving.py:491-524``); both equal the replicate-pad conv, which
   is what the port runs.

The JAX package works on the 2x2 space-to-depth packed tensors of the
256²-level layers and on p-pixel rows in the mid chain; the port's kernels
take the unpacked NHWC tensors. The packed and unpacked convs are the same
function with the same int8 weights and per-channel scales, so the
parameters are quantised from the unpacked folded kernels, with the weight
rule of ``kernels.conv_i8`` (``quantize_kernel``).

Everything is calibrated statically: ``models.packed.calibration_record``
runs the float32 packed forward (``packed_forward``) on a few patches and
records max|x| of each tensor it observes, the tensors that get an int8
scale (scale = max/127 * headroom). The ``prow`` parameters bind
the x2 tables to the LST block size they were built for; ``up2_impl`` picks
their form, 'mxu' (integer numerators, one rounding) or 'vpu' (float32
coefficients, the three roundings of ``upsample_phases``).

``make_int8_sr_step(kernels='alt')`` is a comparison configuration on the
same parameters, as ``mid='xla'`` is: the step's earlier forms of three
layers, inbloc.conv1 on one channel-interleaved input (kernel E), the skip
concats through kernel L and the outlay through kernel F. Each computes the
function of the kernel it stands in for (D, J, the generic conv), so the
``alt`` step's output equals the default step's bit for bit.

On a CUDA device every configuration of the step replays one CUDA graph of
the whole step per row count (``_GraphedStep``): the same kernels, one
launch from the host instead of about 30, bit-equal to the eager step.
"""

from __future__ import annotations

import numpy as np
import torch

from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.kernels import (
    KERNELS,
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1,
    conv_i8_in1_split,
    conv_i8_outlay,
    conv_prow,
    conv_prow_dual,
    conv_prow_dual_planes,
    conv_prow_split_pool,
    conv_prow_up2,
    conv_prow_up2_pack,
    upsample_phases,
)
from sifsr_tpu_torch.kernels.conv_i8 import activation_scale, quantize_activation, quantize_kernel
from sifsr_tpu_torch.kernels.conv_px import prow_leaf, up2_coeffs, up2_coeffs_mxu
from sifsr_tpu_torch.kernels.resize_phases import _device_tables
from sifsr_tpu_torch.models.fused import fold_batchnorm_numpy
from sifsr_tpu_torch.models.packed import calibration_record
from sifsr_tpu_torch.models.quantized import down_block, int8_layers, up_block
from sifsr_tpu_torch.ops.resize import _matrix

__all__ = ["int8_serving_params", "build_int8_serving_params", "prow_mid_params",
           "make_int8_sr_step"]


# ------------------------------------------------------------ parameter build

def _to_device(node, dev: torch.device):
    """Arrays to tensors on ``dev``; Python numbers (the kernels' scalar
    arguments, the block size) stay on the host."""
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    if isinstance(node, (int, float)):
        return node
    return torch.as_tensor(np.asarray(node), device=dev)


def _kb(node):
    """(kernel, bias) of a folded layer."""
    return node["conv"]["kernel"], node["conv"]["bias"]


def prow_mid_params(folded: dict, mid_rec: dict, s: dict, headroom: float, hp: int,
                    up2_impl: str = "mxu") -> dict:
    """The ``mid='prow'`` chain's parameters on the host (port of
    ``pallas_serving._build_prow_mid``, ``pallas_serving.py:292-377``).

    folded: the BN-folded float32 state tree; mid_rec: per-conv input maxes;
    s: the emission scales (``m_*``) of the calibration record; hp: the
    256²-level size / 2 (2 x the LST block size), to which the x2 tables
    are bound. Per-conv input scales come from the same calibration as the
    ``mid='xla'`` chain. The epilogues fold the next tensor's scale in:
    res.conv2 is prescaled by 1/s(lastconv input) with the residual at
    ``res_sc``; db1/db2's lastconv pools at ``pool_sc``; db3's lastconv and
    ub1/ub2's conv2 upsample from their output scale to the consumer's.
    up2_impl: 'mxu' attaches the integer tables of ``up2_coeffs_mxu``, 'vpu'
    the float32 tables of ``up2_coeffs``."""
    if up2_impl not in ("mxu", "vpu"):
        raise ValueError(f"up2_impl must be 'mxu' or 'vpu', got {up2_impl!r}")

    def cal(*path):
        return activation_scale(mid_rec[tuple(path)], headroom)

    def attach_up2(leaf, size, s_mid, s_up):
        """The x2 tables under the keys the step passes to kernels I and K:
        integer numerators ('mxu') or float32 coefficients ('vpu')."""
        coeffs = up2_coeffs_mxu if up2_impl == "mxu" else up2_coeffs
        leaf["rtab"], leaf["ctab"], inv = coeffs(size, size, s_mid, s_up)
        leaf["inv"] = float(inv)

    def down_leaves(name):
        tree = folded[name]
        k1, b1 = _kb(tree["res"]["conv1"])
        k2, b2 = _kb(tree["res"]["conv2"])
        kl, bl = _kb(tree["lastconv"])
        s_in = cal(name, "res", "conv1", "conv")
        s_c2 = cal(name, "res", "conv2", "conv")
        s_lc = cal(name, "lastconv", "conv")
        s_out = s[{"db1": "m_s1", "db2": "m_s2", "db3": "m_t3"}[name]]
        conv1 = prow_leaf(k1, b1, s_in, s_c2)
        conv2 = prow_leaf(k2, b2, s_c2, None, post_scale=1.0 / s_lc)
        conv2["res_sc"] = float(np.float32(s_in / s_lc))
        last = prow_leaf(kl, bl, s_lc, s_out)
        if name in ("db1", "db2"):                  # fused 2x2 pool
            s_next = cal({"db1": "db2", "db2": "db3"}[name], "res", "conv1", "conv")
            last["pool_sc"] = float(np.float32(s_out / (4 * s_next)))
        else:                                       # db3: fused x2 upsample
            attach_up2(last, hp // 4, s["m_t3"], s["m_upt3"])
        return {"conv1": conv1, "conv2": conv2, "last": last}

    def up_leaves(name, s_x, s_z):
        tree = folded[name]["convbloc"]
        k1, b1 = _kb(tree["conv1"])
        k2, b2 = _kb(tree["conv2"])
        s_c2 = cal(name, "convbloc", "conv2", "conv")
        s_out = s[{"ub1": "m_u1", "ub2": "m_u2"}[name]]
        half = k1.shape[2] // 2                     # channels 0:half = up path, half: = skip
        conv1x = prow_leaf(k1[:, :, :half], b1, s_x, s_c2)
        conv1z = prow_leaf(k1[:, :, half:], np.zeros_like(b1), s_z, s_c2)
        conv2 = prow_leaf(k2, b2, s_c2, s_out)
        if name == "ub1":
            attach_up2(conv2, hp // 2, s["m_u1"], s["m_upu1"])
        else:                                       # ub2: the serving tail
            attach_up2(conv2, hp, s["m_u2"], s["up"])
        return {"conv1x": conv1x, "conv1z": conv1z, "conv2": conv2}

    return {
        "db1": down_leaves("db1"),
        "db2": down_leaves("db2"),
        "db3": down_leaves("db3"),
        "ub1": up_leaves("ub1", s["m_upt3"], s["m_s2"]),
        "ub2": up_leaves("ub2", s["m_upu1"], s["m_s1"]),
        "hp": int(hp),
    }


def int8_serving_params(variables: dict, rec: dict, mid_rec: dict, headroom: float = 1.05,
                        device: str | torch.device = "cuda", lst_size: int = 64,
                        up2_impl: str = "mxu") -> dict:
    """ModelB2 state dict + a calibration record -> the int8 step's
    parameters for (N, lst_size, lst_size) LST blocks (JAX
    ``build_pallas_serving_params``): ``mid`` for ``mid='xla'`` and
    ``pmid`` for ``mid='prow'``."""
    dev = resolve_device(device)
    folded = fold_batchnorm_numpy(variables)
    s = {k: activation_scale(v, headroom) for k, v in rec.items()}

    ol_k, ol_b = _kb(folded["outlay"])
    q, sc = quantize_kernel(ol_k)
    ol = {"q": q, "scale": sc, "bias": np.asarray(ol_b, np.float32),
          "in_scale": np.float32(s["ol"])}

    w1, b1 = _kb(folded["inbloc"]["conv1"])
    q1, sw1 = quantize_kernel(w1)
    in1 = {
        "w": q1,
        "scale": (s["in1"] * sw1 / s["in2"]).astype(np.float32),
        "bias": (np.asarray(b1, np.float64) / s["in2"]).astype(np.float32),
        "in_scale": np.float32(s["in1"]),
    }
    in2 = prow_leaf(*_kb(folded["inbloc"]["conv2"]), s["in2"], s["s0"])

    # ub3.conv1 split halves: input channels 0:16 = up path, 16:32 = skip s0
    w31, b31 = _kb(folded["ub3"]["convbloc"]["conv1"])
    qa, swa = quantize_kernel(w31[:, :, :16])
    qb, swb = quantize_kernel(w31[:, :, 16:])
    u31 = {
        "wx": qa, "wz": qb,
        "scale_x": (s["up"] * swa / s["u32"]).astype(np.float32),
        "scale_z": (s["s0"] * swb / s["u32"]).astype(np.float32),
        "bias": (np.asarray(b31, np.float64) / s["u32"]).astype(np.float32),
    }
    u32 = prow_leaf(*_kb(folded["ub3"]["convbloc"]["conv2"]), s["u32"], s["ol"])

    def walk_mid(node, base):
        if "kernel" in node:
            q, sc = quantize_kernel(node["kernel"])
            return {"q": q, "scale": sc, "bias": np.asarray(node["bias"], np.float32),
                    "in_scale": np.float32(activation_scale(mid_rec[base], headroom))}
        return {k: walk_mid(v, base + (k,)) for k, v in node.items()}

    mid = {k: walk_mid(folded[k], (k,)) for k in ("db1", "db2", "db3", "ub1", "ub2")}
    pmid = prow_mid_params(folded, mid_rec, s, headroom, 2 * lst_size, up2_impl)
    s32 = {k: np.float32(v) for k, v in s.items()}
    s_db1 = mid["db1"]["res"]["conv1"]["conv"]["in_scale"]
    params = _to_device({"in1": in1, "in2": in2, "u31": u31, "u32": u32, "ol": ol,
                         "mid": mid, "pmid": pmid}, dev)
    params["s"] = s32
    # float32 phase_mean / 4 of the fused phase-mean output (conv_i8.py:386)
    params["pm_scale"] = float(s32["s0"] / s_db1 / np.float32(4.0))
    return params


def build_int8_serving_params(variables: dict, sample_lst, sample_ndvi, stats,
                              headroom: float = 1.05, calib_quantile: float | None = None,
                              device: str | torch.device = "cuda",
                              up2_impl: str = "mxu") -> dict:
    """ModelB2 state dict + calibration patches -> the int8 step's parameters,
    for LST blocks of the patches' size.
    calib_quantile: None uses max|x| per tensor; a quantile clips the tail."""
    rec, mid_rec = calibration_record(variables, sample_lst, sample_ndvi, stats, calib_quantile,
                                      device)
    return int8_serving_params(variables, rec, mid_rec, headroom, device,
                               lst_size=np.asarray(sample_lst).shape[1], up2_impl=up2_impl)


# -------------------------------------------------------------- serving step

def _xla_mid(mid: dict, pm: torch.Tensor) -> torch.Tensor:
    """db1..db3, ub1, ub2 from the int8 phase mean (at db1's input scale) to
    ub2's float32 output (``pallas_serving.py:586-598``): the blocks of
    ``models.quantized`` on the int8 convs of ``mid``."""
    conv = int8_layers(mid)
    leaf = mid["db1"]["res"]["conv1"]["conv"]
    s_db1 = leaf["in_scale"]
    # pm is already int8 at db1's input scale: the conv takes it unquantised
    r = conv_i8_generic(pm, leaf["q"], s_db1 * leaf["scale"], leaf["bias"], True)
    r = conv(r, ("db1", "res", "conv2", "conv"))
    s1m = conv(pm.to(torch.float32) * s_db1 + r, ("db1", "lastconv", "conv"))
    s2 = down_block(conv, s1m, "db2")
    t = down_block(conv, s2, "db3")
    t = up_block(conv, t, s2, "ub1")
    return up_block(conv, t, s1m, "ub2")


def _prow_mid(pmid: dict, pm: torch.Tensor, dual_kernel=conv_prow_dual_planes) -> torch.Tensor:
    """db1..db3, ub1, ub2 as kernels G-K (``pallas_serving.py:395-440``):
    the int8 phase mean (N, hp, hp, 16) at db1's input scale -> ub2's x2
    output (N, 2hp, 2hp, 16) int8 at the ``up`` scale. dual_kernel: J, or L
    for the ``alt`` step."""

    def down(tree, x):
        c1, c2 = tree["conv1"], tree["conv2"]
        a = conv_prow(x, c1["w"], c1["scale"], c1["bias"])
        return conv_prow(a, c2["w"], c2["scale"], c2["bias"], residual=x, res_sc=c2["res_sc"])

    def pool(tree, x):
        last = tree["last"]
        return conv_prow_split_pool(x, last["w"], last["scale"], last["bias"], last["pool_sc"])

    def up2(kernel, leaf, x):
        return kernel(x, leaf["w"], leaf["scale"], leaf["bias"], leaf["rtab"], leaf["ctab"],
                      leaf["inv"])

    def dual(tree, up, skip):
        cx, cz = tree["conv1x"], tree["conv1z"]
        return dual_kernel(up, skip, cx["w"], cz["w"], cx["scale"], cz["scale"], cx["bias"])

    s1, x2 = pool(pmid["db1"], down(pmid["db1"], pm))
    s2, x3 = pool(pmid["db2"], down(pmid["db2"], x2))
    up3 = up2(conv_prow_up2, pmid["db3"]["last"], down(pmid["db3"], x3))
    upu1 = up2(conv_prow_up2, pmid["ub1"]["conv2"], dual(pmid["ub1"], up3, s2))
    return up2(conv_prow_up2_pack, pmid["ub2"]["conv2"], dual(pmid["ub2"], upu1, s1))


def _leaves(nodes, out: list) -> list:
    """The leaves under ``nodes`` (parameter subtrees or leaves), depth
    first in insertion order."""
    for v in nodes:
        if v.__class__ is dict:
            _leaves(v.values(), out)
        else:
            out.append(v)
    return out


def _cached_tables(lst: torch.Tensor, mid: str) -> list:
    """The device tables the step takes from module caches for LST blocks
    like ``lst``, fetched as the step's calls fetch them (kernel A's from
    ``resize_phases._device_tables``, the ``xla`` chain's x2 matrices from
    ``ops.resize._matrix``). A graph holds them, so that a cache's eviction
    cannot free memory the graph reads."""
    h, w, dev = lst.shape[1], lst.shape[2], lst.device
    held = [_device_tables(h, w, 4, "cubic", dev, None)]
    if mid == "xla":               # the phase mean is at 2h: db3 at h/2, ub1 at h
        held.append(_device_tables(2 * h, 2 * w, 2, "linear_ac", dev, None))
        for a, b in ((h // 2, h), (w // 2, w), (h, 2 * h), (w, 2 * w)):
            held.append(_matrix(a, b, "linear_ac", torch.float32, dev))
    return held


class _GraphedStep:
    """The int8 step on a CUDA device: one CUDA graph of the whole step per
    row count, replayed.

    A call at a row count with no graph runs the step eagerly and returns
    that output; then it captures the step at that count, reading views of
    the static inputs and writing a view of the static output. A later call
    at that count copies its inputs into the static inputs, replays the
    graph on the current stream and returns a copy of the static output,
    made on that stream: the caller owns it, and no later call writes it.

    The graphs are keyed by the blocks' shapes and by the parameters they
    were captured with: the identity of every leaf of the tree the step
    reads, its device tensors and its Python numbers, each held so that its
    id stays its own while the graphs live. Memory held does not
    grow with the row counts seen: the static inputs and output are one
    buffer set of the most rows seen so far, every graph is captured into
    one shared memory pool, and the replays run one after another on one
    stream, so each graph's intermediates may take the memory of
    another's. New parameters, new block shapes or more rows than the
    buffers hold drop every graph, the buffers and the pool (the next
    capture frees the pool's memory), and the graphs are captured anew.

    Under ``tracing`` a replay counts ``graph_replays`` and a capture
    ``graph_captures``. A replay adds to each kernel's ``launches`` what the
    capture launched, so the counts read as the eager step's."""

    def __init__(self, eager, dev: torch.device, mid: str):
        self.eager, self.dev, self.mid = eager, dev, mid
        self.reads = ("in1", "in2", "u31", "u32", "ol", "s", "pm_scale",
                      "pmid" if mid == "prow" else "mid")
        self.graphs: dict = {}       # rows -> (CUDAGraph, ((kernel, launches), ...))
        self.key = None
        self.rows = 0
        self.held: tuple = ()
        self.lst = self.ndvi = self.out = self.pool = self.stream = None

    def _key(self, params, lst, ndvi):
        leaves = _leaves(map(params.__getitem__, self.reads), [])
        return (tuple(lst.shape[1:]), tuple(ndvi.shape[1:]), tuple(map(id, leaves))), leaves

    @torch.no_grad()
    def __call__(self, params, lst_blocks, ndvi_blocks):
        lst = torch.as_tensor(lst_blocks, dtype=torch.float32, device=self.dev)
        ndvi = torch.as_tensor(ndvi_blocks, dtype=torch.float32, device=self.dev)
        n = lst.shape[0]
        key, leaves = self._key(params, lst, ndvi)
        graph = self.graphs.get(n) if key == self.key and ndvi.shape[0] == n else None
        if graph is None:
            out = self.eager(params, lst, ndvi)
            self._capture(params, key, leaves, lst, out)
            return out
        stream = torch.cuda.current_stream(self.dev)
        if stream != self.stream:
            if self.stream is not None:
                stream.wait_stream(self.stream)
            self.stream = stream
        self.lst[:n].copy_(lst)
        self.ndvi[:n].copy_(ndvi)
        graph[0].replay()
        for kernel, launches in graph[1]:
            kernel.launches += launches
        tracing.count("graph_replays", 1)
        return self.out[:n].clone()

    def _capture(self, params, key, leaves, lst, out) -> None:
        n = lst.shape[0]
        if key != self.key or n > self.rows:
            rows = max(n, self.rows) if key == self.key else n
            if self.graphs:
                torch.cuda.synchronize(self.dev)
            # the old set goes before the new one is allocated
            self.graphs, self.lst, self.ndvi, self.out, self.pool = {}, None, None, None, None
            self.lst = torch.empty((rows, *key[0]), dtype=torch.float32, device=self.dev)
            self.ndvi = torch.empty((rows, *key[1]), dtype=torch.float32, device=self.dev)
            self.out = torch.empty((rows, *out.shape[1:]), dtype=out.dtype, device=self.dev)
            self.pool = torch.cuda.graph_pool_handle()
            self.key, self.rows, self.stream = key, rows, None
            self.held = (leaves, _cached_tables(self.lst, self.mid))
        before = [k.launches for k in KERNELS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.out[:n].copy_(self.eager(params, self.lst[:n], self.ndvi[:n]))
            launched = tuple((k, k.launches - b) for k, b in zip(KERNELS, before)
                             if k.launches != b)
        finally:                    # a capture launches nothing
            for k, b in zip(KERNELS, before):
                k.launches = b
        self.graphs[n] = (graph, launched)
        tracing.count("graph_captures", 1)


def make_int8_sr_step(stats, mid: str = "prow", kernels: str = "default",
                      device: str | torch.device = "cuda"):
    """The int8 twin of ``inference.make_sr_step``:
    (params, lst (N,h,h) K, ndvi (N,4h,4h)) -> (N,4h,4h) K, params from
    ``build_int8_serving_params`` on the same device. mid: 'prow' (the
    default, kernels G-K) or 'xla' (the JAX comparison chain). kernels:
    'default', or 'alt' for the comparison step that runs inbloc.conv1
    through kernel E, the prow skip concats through L and the outlay through
    F; its output equals the default step's bit for bit.

    On a CUDA device the step replays one CUDA graph of the whole step per
    row count (``_GraphedStep``): the first call at a row count runs
    eagerly and captures, later calls copy their inputs in, replay, and
    return a copy of the output that is the caller's. Memory held is one
    set of static inputs and output of the most rows seen and one memory
    pool shared by every graph, so it does not grow with the row counts
    seen. On the CPU the step is the eager step. Either way ``step.eager``
    is the eager step, bit-equal per row."""
    if mid not in ("prow", "xla"):
        raise ValueError(f"mid must be 'prow' or 'xla', got {mid!r}")
    if kernels not in ("default", "alt"):
        raise ValueError(f"kernels must be 'default' or 'alt', got {kernels!r}")
    alt = kernels == "alt"
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    mean_lst, std_lst = f32(stats.mean_lst), f32(stats.std_lst)
    mean_ndvi, std_ndvi = f32(stats.mean_ndvi), f32(stats.std_ndvi)

    @torch.no_grad()
    def sr_step(params, lst_blocks, ndvi_blocks):
        lst = torch.as_tensor(lst_blocks, dtype=torch.float32, device=dev)
        ndvi = torch.as_tensor(ndvi_blocks, dtype=torch.float32, device=dev)
        if mid == "prow" and 2 * lst.shape[1] != params["pmid"]["hp"]:
            raise ValueError(f"the prow parameters were built for {params['pmid']['hp'] // 2}² "
                             f"LST blocks, got {lst.shape[1]}²")
        s = params["s"]
        in1, in2, u31, u32, ol = (params[k] for k in ("in1", "in2", "u31", "u32", "ol"))
        lst_n = (lst - mean_lst) / std_lst
        ndvi_n = (ndvi - mean_ndvi) / std_ndvi
        lst_q = upsample_phases(lst_n[..., None], 4, "cubic", scale=s["in1"])[..., 0]
        ndvi_q = quantize_activation(ndvi_n, in1["in_scale"])
        if alt:
            s1 = conv_i8_in1(torch.stack([lst_q, ndvi_q], dim=-1), in1["w"], in1["scale"],
                             in1["bias"])
        else:
            s1 = conv_i8_in1_split(lst_q, ndvi_q, in1["w"], in1["scale"], in1["bias"])
        s0, pm = conv_i8_exact(s1, in2["w"], in2["scale"], in2["bias"],
                               pm_scale=params["pm_scale"])
        if mid == "prow":
            up = _prow_mid(params["pmid"], pm, conv_prow_dual if alt else conv_prow_dual_planes)
        else:
            up = upsample_phases(_xla_mid(params["mid"], pm), 2, "linear_ac", scale=s["up"])
        u = conv_i8_exact_dual(up, s0, u31["wx"], u31["wz"], u31["scale_x"],
                               u31["scale_z"], u31["bias"])
        olp = conv_i8_exact(u, u32["w"], u32["scale"], u32["bias"])
        # the Kelvin de-normalise folds into the dequantise step
        ol_sc = ol["in_scale"] * ol["scale"] * std_lst
        ol_b = ol["bias"] * std_lst + mean_lst
        if alt:
            return conv_i8_outlay(olp, ol["q"], ol_sc, ol_b)
        return conv_i8_generic(olp, ol["q"], ol_sc, ol_b, relu=False)[..., 0]

    sr_step.eager = sr_step
    if dev.type != "cuda":
        return sr_step
    return _GraphedStep(sr_step, dev, mid)
