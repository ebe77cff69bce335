"""The int8 serving step with its hand-written kernels (mid='xla').

Counterpart of ``sifsr_tpu/models/pallas_serving.py`` ("pallas" would
mislead here). Per batch (N, 64, 64) K LST + (N, 256, 256) NDVI:

1. normalise; cubic x4 of the LST with the int8 quantisation fused into the
   kernel's epilogue (kernel A); NDVI quantised by division;
2. inbloc.conv1 over the separate LST/NDVI int8 planes (kernel D);
3. inbloc.conv2 -> s0 int8, with the mid chain's input (the 2x2 phase mean
   of s0, requantised to db1's input scale) as a fused second output
   (kernel B);
4. the mid chain db1..db3, ub1, ub2 as calibrated int8 convs
   (``models.quantized_packed``, the JAX ``mid='xla'`` chain);
5. align-corners x2 of the mid output quantised to the ``up`` scale
   (kernel A), ub3.conv1 over concat(up, s0) without forming the concat
   (kernel C), ub3.conv2 (kernel B);
6. the outlay, a replicate-pad 16->1 int8 conv with the Kelvin de-normalise
   folded into its dequantise step. The JAX step computes it as a
   zero-padded conv plus exact replicate border strips
   (``pallas_serving.py:491-524``); both equal the replicate-pad conv, which
   is what the port runs.

The JAX package works on the 2x2 space-to-depth packed tensors of the
256²-level layers; the port's kernels take the unpacked NHWC tensors. The
packed and unpacked convs are the same function with the same int8 weights
and per-channel scales, so the parameters are quantised from the unpacked
folded kernels.

Everything is calibrated statically: ``_f32_packed_mirror`` runs the float32
packed graph on a few patches and records max|x| of each tensor that gets
an int8 scale (scale = max/127 * headroom).

``mid='prow'`` (the JAX default: the mid chain as the conv_px kernels G-K)
is not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32_convs, resolve_device
from sifsr_tpu_torch.kernels import (
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1_split,
    upsample_phases,
)
from sifsr_tpu_torch.models.fused import fold_batchnorm, upsample_bilinear_x2_nhwc
from sifsr_tpu_torch.models.packed import (
    _packed_concat,
    _packed_resize,
    _phase_matrices,
    _replicate_pad_packed,
    _space_to_depth,
    _to_numpy_tree,
    pack_serving_params,
)
from sifsr_tpu_torch.models.quantized import _quantize_kernel
from sifsr_tpu_torch.models.quantized_packed import _conv_i8_mid, _double_mid, _down, _quant

__all__ = ["calibrate", "int8_serving_params", "build_int8_serving_params",
           "make_int8_sr_step"]


# ---------------------------------------------------------------- calibration

def _conv_valid(x: torch.Tensor, kernel, bias, relu: bool) -> torch.Tensor:
    """VALID float32 conv of a pre-padded NHWC tensor, HWIO numpy kernel."""
    k = torch.as_tensor(kernel, device=x.device).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    y = y + torch.as_tensor(bias, device=x.device)
    return torch.clamp_min(y, 0.0) if relu else y


@torch.no_grad()
def _f32_packed_mirror(pp: dict, sample_lst, sample_ndvi, stats, quantile=None,
                       device: str | torch.device = "cpu"):
    """Run the float32 packed forward on calibration patches, recording max|x|
    (or the ``quantile`` of |x|) of every tensor that gets an int8 scale.
    Returns (record dict, mid-chain input maxes dict keyed by tree path)."""
    dev = torch.device(device)
    rec: dict = {}
    mid_rec: dict = {}

    def _amax(x):
        if quantile is None:
            return float(x.abs().max())
        return float(np.quantile(x.abs().cpu().numpy().ravel(), quantile))

    def conv_mid(x, tree, path, relu=True):
        mid_rec[path] = _amax(x)
        xx = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
        return _conv_valid(xx, tree["kernel"], tree["bias"], relu)

    def conv_packed(x, wp_bp, c_in, relu=True):
        return _conv_valid(_replicate_pad_packed(x, c_in), wp_bp[0], wp_bp[1], relu)

    with full_f32_convs():
        lst_n = (torch.as_tensor(sample_lst, dtype=torch.float32, device=dev)
                 - stats.mean_lst) / stats.std_lst
        ndvi_n = (torch.as_tensor(sample_ndvi, dtype=torch.float32, device=dev)
                  - stats.mean_ndvi) / stats.std_ndvi
        h = lst_n.shape[1]
        lst_up_p = _packed_resize(lst_n[..., None], _phase_matrices(h, 4 * h, "cubic"))
        ndvi_p = _space_to_depth(ndvi_n[..., None])

        mid, pk = pp["mid"], pp["packed"]
        c0 = 16
        x = _packed_concat(lst_up_p, 1, ndvi_p, 1)
        rec["in1"] = _amax(x)
        x = conv_packed(x, pk["in_conv1"], 2)
        rec["in2"] = _amax(x)
        s0p = conv_packed(x, pk["in_conv2"], c0)
        rec["s0"] = _amax(s0p)
        n, hh, ww, _ = s0p.shape

        def double_mid(x, tree, base):
            x = conv_mid(x, tree["conv1"]["conv"], base + ("conv1", "conv"))
            return conv_mid(x, tree["conv2"]["conv"], base + ("conv2", "conv"))

        def down_body(x, tree, base):
            x = x + double_mid(x, tree["res"], base + ("res",))
            return conv_mid(x, tree["lastconv"]["conv"], base + ("lastconv", "conv"))

        def down(x, tree, base):
            nn_, h_, w_, c_ = x.shape
            x = x.reshape(nn_, h_ // 2, 2, w_ // 2, 2, c_).mean(dim=(2, 4))
            return down_body(x, tree, base)

        def rec_max(key, x):
            rec[key] = _amax(x)
            return x

        s1 = down_body(s0p.reshape(n, hh, ww, 4, c0).mean(dim=3), mid["db1"], ("db1",))
        rec_max("m_s1", s1)
        s2 = down(s1, mid["db2"], ("db2",))
        rec_max("m_s2", s2)
        t = down(s2, mid["db3"], ("db3",))
        rec_max("m_t3", t)
        t = double_mid(torch.cat([rec_max("m_upt3", upsample_bilinear_x2_nhwc(t)), s2], -1),
                       mid["ub1"]["convbloc"], ("ub1", "convbloc"))
        rec_max("m_u1", t)
        t = double_mid(torch.cat([rec_max("m_upu1", upsample_bilinear_x2_nhwc(t)), s1], -1),
                       mid["ub2"]["convbloc"], ("ub2", "convbloc"))
        rec_max("m_u2", t)
        up_p = _packed_resize(t, _phase_matrices(t.shape[1], 2 * t.shape[1], "linear_ac"))
        rec["up"] = _amax(up_p)
        u31 = conv_packed(_packed_concat(up_p, c0, s0p, c0), pk["ub3_conv1"], 2 * c0)
        rec["u32"] = _amax(u31)
        u32 = conv_packed(u31, pk["ub3_conv2"], c0)
        rec["ol"] = _amax(u32)
    return rec, mid_rec


def calibrate(variables: dict, sample_lst, sample_ndvi, stats, calib_quantile=None,
              device: str | torch.device = "cuda"):
    """(record, mid record) of ``_f32_packed_mirror`` for a ModelB2 state
    dict on calibration patches, sample_lst (N,64,64) K, sample_ndvi
    (N,256,256)."""
    dev = resolve_device(device)
    return _f32_packed_mirror(pack_serving_params(variables), sample_lst, sample_ndvi,
                              stats, calib_quantile, dev)


# ------------------------------------------------------------ parameter build

def _leaf(kernel, bias, s_in, s_out) -> dict:
    """int8 weights with the input and output scales folded into the
    per-channel dequantise scale/bias (``pallas_serving.pallas_leaf``)."""
    q, sw = _quantize_kernel(kernel)
    comb = s_in * sw
    b = np.asarray(bias, np.float64)
    if s_out is not None:
        comb, b = comb / s_out, b / s_out
    return {"w": q, "scale": comb.astype(np.float32), "bias": b.astype(np.float32)}


def _to_device(node, dev: torch.device):
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    return torch.as_tensor(np.asarray(node), device=dev)


def int8_serving_params(variables: dict, rec: dict, mid_rec: dict, headroom: float = 1.05,
                        device: str | torch.device = "cuda") -> dict:
    """ModelB2 state dict + a calibration record -> the int8 step's
    parameters (JAX ``build_pallas_serving_params`` without ``pmid``)."""
    dev = resolve_device(device)
    folded = _to_numpy_tree(fold_batchnorm(variables))
    s = {k: v / 127.0 * headroom for k, v in rec.items()}

    def kb(node):
        return node["conv"]["kernel"], node["conv"]["bias"]

    ol_k, ol_b = kb(folded["outlay"])
    q, sc = _quantize_kernel(ol_k)
    ol = {"q": q, "scale": sc, "bias": np.asarray(ol_b, np.float32),
          "in_scale": np.float32(s["ol"])}

    w1, b1 = kb(folded["inbloc"]["conv1"])
    q1, sw1 = _quantize_kernel(w1)
    in1 = {
        "w": q1,
        "scale": (s["in1"] * sw1 / s["in2"]).astype(np.float32),
        "bias": (np.asarray(b1, np.float64) / s["in2"]).astype(np.float32),
        "in_scale": np.float32(s["in1"]),
    }
    in2 = _leaf(*kb(folded["inbloc"]["conv2"]), s["in2"], s["s0"])

    # ub3.conv1 split halves: input channels 0:16 = up path, 16:32 = skip s0
    w31, b31 = kb(folded["ub3"]["convbloc"]["conv1"])
    qa, swa = _quantize_kernel(w31[:, :, :16])
    qb, swb = _quantize_kernel(w31[:, :, 16:])
    u31 = {
        "wx": qa, "wz": qb,
        "scale_x": (s["up"] * swa / s["u32"]).astype(np.float32),
        "scale_z": (s["s0"] * swb / s["u32"]).astype(np.float32),
        "bias": (np.asarray(b31, np.float64) / s["u32"]).astype(np.float32),
    }
    u32 = _leaf(*kb(folded["ub3"]["convbloc"]["conv2"]), s["u32"], s["ol"])

    def walk_mid(node, base):
        if "kernel" in node:
            q, sc = _quantize_kernel(node["kernel"])
            return {"q": q, "scale": sc, "bias": np.asarray(node["bias"], np.float32),
                    "in_scale": np.float32(mid_rec[base] / 127.0 * headroom)}
        return {k: walk_mid(v, base + (k,)) for k, v in node.items()}

    mid = {k: walk_mid(folded[k], (k,)) for k in ("db1", "db2", "db3", "ub1", "ub2")}
    s32 = {k: np.float32(v) for k, v in s.items()}
    s_db1 = mid["db1"]["res"]["conv1"]["conv"]["in_scale"]
    params = _to_device({"in1": in1, "in2": in2, "u31": u31, "u32": u32, "ol": ol,
                         "mid": mid}, dev)
    params["s"] = s32
    # float32 phase_mean / 4 of the fused phase-mean output (conv_i8.py:386)
    params["pm_scale"] = float(s32["s0"] / s_db1 / np.float32(4.0))
    return params


def build_int8_serving_params(variables: dict, sample_lst, sample_ndvi, stats,
                              headroom: float = 1.05, calib_quantile: float | None = None,
                              device: str | torch.device = "cuda") -> dict:
    """ModelB2 state dict + calibration patches -> the int8 step's parameters.
    calib_quantile: None uses max|x| per tensor; a quantile clips the tail."""
    rec, mid_rec = calibrate(variables, sample_lst, sample_ndvi, stats, calib_quantile, device)
    return int8_serving_params(variables, rec, mid_rec, headroom, device)


# -------------------------------------------------------------- serving step

def _xla_mid(mid: dict, pm: torch.Tensor) -> torch.Tensor:
    """db1..db3, ub1, ub2 from the int8 phase mean (at db1's input scale) to
    ub2's float32 output (``pallas_serving.py:586-598``)."""
    db1 = mid["db1"]
    leaf = db1["res"]["conv1"]["conv"]
    s_db1 = leaf["in_scale"]
    # pm is already int8 at db1's input scale: the conv takes it unquantised
    r = conv_i8_generic(pm, leaf["q"], s_db1 * leaf["scale"], leaf["bias"], True)
    r = _conv_i8_mid(r, db1["res"]["conv2"]["conv"])
    s1m = _conv_i8_mid(pm.to(torch.float32) * s_db1 + r, db1["lastconv"]["conv"])
    s2 = _down(s1m, mid["db2"])
    t = _down(s2, mid["db3"])
    t = _double_mid(torch.cat([upsample_bilinear_x2_nhwc(t), s2], -1), mid["ub1"]["convbloc"])
    return _double_mid(torch.cat([upsample_bilinear_x2_nhwc(t), s1m], -1),
                       mid["ub2"]["convbloc"])


def make_int8_sr_step(stats, mid: str = "xla", device: str | torch.device = "cuda"):
    """The int8 twin of ``inference.make_sr_step``:
    (params, lst (N,64,64) K, ndvi (N,256,256)) -> (N,256,256) K, params
    from ``build_int8_serving_params`` on the same device."""
    if mid == "prow":
        raise NotImplementedError(
            "mid='prow' needs the conv_px kernels (G-K), which are not ported yet "
            "(ROADMAP.md, TPU kernel queue); use mid='xla'")
    if mid != "xla":
        raise ValueError(f"mid must be 'xla' or 'prow', got {mid!r}")
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    mean_lst, std_lst = f32(stats.mean_lst), f32(stats.std_lst)
    mean_ndvi, std_ndvi = f32(stats.mean_ndvi), f32(stats.std_ndvi)

    @torch.no_grad()
    def sr_step(params, lst_blocks, ndvi_blocks):
        lst = torch.as_tensor(lst_blocks, dtype=torch.float32, device=dev)
        ndvi = torch.as_tensor(ndvi_blocks, dtype=torch.float32, device=dev)
        s = params["s"]
        in1, in2, u31, u32, ol = (params[k] for k in ("in1", "in2", "u31", "u32", "ol"))
        lst_n = (lst - mean_lst) / std_lst
        ndvi_n = (ndvi - mean_ndvi) / std_ndvi
        lst_q = upsample_phases(lst_n[..., None], 4, "cubic", scale=s["in1"])[..., 0]
        ndvi_q = _quant(ndvi_n, in1["in_scale"])
        s1 = conv_i8_in1_split(lst_q, ndvi_q, in1["w"], in1["scale"], in1["bias"])
        s0, pm = conv_i8_exact(s1, in2["w"], in2["scale"], in2["bias"],
                               pm_scale=params["pm_scale"])
        t = _xla_mid(params["mid"], pm)
        up = upsample_phases(t, 2, "linear_ac", scale=s["up"])
        u = conv_i8_exact_dual(up, s0, u31["wx"], u31["wz"], u31["scale_x"],
                               u31["scale_z"], u31["bias"])
        olp = conv_i8_exact(u, u32["w"], u32["scale"], u32["bias"])
        # the Kelvin de-normalise folds into the dequantise step
        ol_sc = ol["in_scale"] * ol["scale"] * std_lst
        ol_b = ol["bias"] * std_lst + mean_lst
        return conv_i8_generic(olp, ol["q"], ol_sc, ol_b, relu=False)[..., 0]

    return sr_step
