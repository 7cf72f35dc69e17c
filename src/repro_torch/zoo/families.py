"""Model zoo — the Table-2 families as PyTorch shape programs.

The port of ``repro.zoo.families``. The paper's dataset (10,508 graphs)
spans Efficientnet / Mnasnet / Mobilenet / Resnet / Vgg / Swin / ViT /
Densenet / Visformer / Poolformer at many depth / width / resolution /
batch points; ConvNeXt is held out (Table 5 "unseen"). Each family is a
generator ``build(variant_cfg) -> (param_specs, forward, meta)`` where
``param_specs`` is a dict of tensors on the ``meta`` device (no
allocation) and ``forward(params, x)`` takes an NHWC image batch. The
models only ever run under :func:`repro_torch.core.tracer.trace_graph`:
they are shape programs, and the operator graph is what DIPPM needs.

Each family is written from the reference's primitives, not from the
PyTorch idiom, because the labels depend on how many pointwise nodes
fuse into each group: a mean is a sum and a divide, GELU is its tanh
formula, softmax is max / subtract / exp / sum / divide, ReLU6 is a
max and a min, a dense layer is ``x @ w + b``, a variance is
``jnp.var``'s own steps, and average pooling is a window sum and a
divide. The layout steps are the reference's too: each is written as
the ATen op that ``core.tracer``'s raw-node rule counts as the
reference's equations (the attention's products as its two
``dot_general`` equations, ``[:, None, None, :]`` as one reshape, a
converted scalar as a ``_to_copy``).

Activations are NHWC from the input to the head, as the reference's
are. Only the torch convolution or pooling call sees NCHW, between a
``permute(0, 3, 1, 2)`` and a ``permute(0, 2, 3, 1)``, with OIHW
weights (parameter bytes do not depend on layout); the tracer records
such a call at its NHWC shape and the two permutes add no raw node.
"SAME" padding gives the reference's output shapes: symmetric padding
where that gives the same size, an explicit ``F.pad`` otherwise.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32


# ---------------------------------------------------------------------------
# spec-building helpers
# ---------------------------------------------------------------------------

def S(*shape) -> torch.Tensor:
    """A float32 parameter spec on the meta device."""
    return torch.empty(shape, dtype=F32, device="meta")


def _conv_spec(cin, cout, k=3):
    return {"w": S(cout, cin, k, k)}


def _dw_spec(c, k=3):
    # depthwise: OIHW with I=1, groups=c
    return {"w": S(c, 1, k, k)}


def _dense_spec(din, dout, bias=True):
    p = {"w": S(din, dout)}
    if bias:
        p["b"] = S(dout)
    return p


def _ln_spec(d):
    return {"g": S(d), "b": S(d)}


def _bn_spec(c):
    return {"g": S(c), "b": S(c)}


# ---------------------------------------------------------------------------
# forward helpers (NHWC images, [B, N, D] tokens)
# ---------------------------------------------------------------------------

def _same(size: int, k: int, s: int):
    """(output size, total padding) of a "SAME" window op."""
    out = -(-size // s)
    return out, max((out - 1) * s + k - size, 0)


def _same_padding(x, k: int, s: int, value: float = 0.0):
    """(NCHW input, symmetric padding) that give the "SAME" output size:
    the symmetric padding when it does, else the input padded
    explicitly."""
    h = int(x.shape[-1])
    out, total = _same(h, k, s)
    p = (total + 1) // 2
    if p <= k // 2 and (h + 2 * p - k) // s + 1 == out:
        return x, p
    lo = total // 2
    return F.pad(x, (lo, total - lo, lo, total - lo), value=value), 0


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv(p, x, stride=1, groups=1, padding="SAME"):
    w = p["w"]
    x = _nchw(x)
    if padding == "VALID":
        return _nhwc(F.conv2d(x, w, stride=stride, groups=groups))
    x, pad = _same_padding(x, int(w.shape[-1]), stride)
    return _nhwc(F.conv2d(x, w, stride=stride, padding=pad, groups=groups))


def dwconv(p, x, stride=1, padding="SAME"):
    return conv(p, x, stride, groups=int(x.shape[-1]), padding=padding)


def bn(p, x):
    # inference-mode affine (folded statistics)
    return x * p["g"] + p["b"]


def _var(x):
    """``jnp.var(x, axis=-1, keepdims=True)``, step for step: the mean,
    the squared deviations, ``n - ddof`` from a converted scalar, the
    divide, and the ``where`` that makes a zero count NaN (a converted
    and broadcast NaN)."""
    n = x.shape[-1]
    c = x - x.sum(-1, keepdim=True) / n
    sq = torch.square(c)
    dof = n - torch.zeros((), dtype=torch.int32, device=x.device).to(x.dtype)
    v = sq.sum(-1, keepdim=True) / dof
    nan = torch.scalar_tensor(math.nan, dtype=torch.float64,
                              device=x.device).to(x.dtype)
    return torch.where(dof > 0, v, nan.expand(v.shape))


def ln(p, x, eps=1e-6):
    mu = x.sum(-1, keepdim=True) / x.shape[-1]
    var = _var(x)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def dense(p, x):
    """``x @ w + b`` as one ``mm`` over the rows of ``x`` (``matmul``
    would take ``bmm`` over a copy of ``w`` per batch for some strides)."""
    w = p["w"]
    y = (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])
    return y + p["b"] if "b" in p else y


def relu6(x):
    return x.clamp_min(0.0).clamp_max(6.0)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s tanh approximation, op for op."""
    cdf = 0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return x * cdf


def softmax(x):
    """``jax.nn.softmax`` over the last axis: max, subtract, exp, sum,
    divide (the max clamped at -inf and detached, as the reference's)."""
    m = x.amax(-1).clamp_min(-math.inf).unsqueeze(-1).detach()
    e = torch.exp(x - m)
    return e / e.sum(-1, keepdim=True)


def maxpool(x, k=2, s=2):
    x, pad = _same_padding(_nchw(x), k, s, value=-math.inf)
    return _nhwc(F.max_pool2d(x, k, s, padding=pad))


def avgpool(x, k=2, s=2):
    x, pad = _same_padding(_nchw(x), k, s)
    summed = F.avg_pool2d(x, k, s, padding=pad, divisor_override=1)
    return _nhwc(summed) / float(k * k)


def gap(x):
    return x.sum((1, 2)) / (x.shape[1] * x.shape[2])


def _tokens(x):
    """NHWC feature map → [B, H·W, C] tokens."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def mha(p, x, heads):
    """The reference's two einsums as its ``dot_general`` equations
    compute them: ``[b, h, n, m]`` scores, then ``[b, h, d, n]``
    transposed to ``[b, n, h, d]``; the scale is a converted
    ``jnp.sqrt`` of a float."""
    B, N, D = x.shape
    q = dense(p["q"], x).reshape(B, N, heads, D // heads)
    k = dense(p["k"], x).reshape(B, N, heads, D // heads)
    v = dense(p["v"], x).reshape(B, N, heads, D // heads)
    att = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
    scale = torch.sqrt(torch.scalar_tensor(D / heads, device=x.device))
    att = att / scale.to(x.dtype, copy=True)
    att = softmax(att)
    o = torch.matmul(v.permute(0, 2, 3, 1), att.transpose(-1, -2))
    return dense(p["o"], o.permute(0, 3, 1, 2).reshape(B, N, D))


def _mha_spec(d):
    return {"q": _dense_spec(d, d), "k": _dense_spec(d, d),
            "v": _dense_spec(d, d), "o": _dense_spec(d, d)}


def tx_block(p, x, heads, mlp_ratio=4):
    x = x + mha(p["attn"], ln(p["ln1"], x), heads)
    h = dense(p["fc1"], ln(p["ln2"], x))
    h = gelu(h)
    x = x + dense(p["fc2"], h)
    return x


def _tx_spec(d, mlp_ratio=4):
    return {"ln1": _ln_spec(d), "attn": _mha_spec(d), "ln2": _ln_spec(d),
            "fc1": _dense_spec(d, d * mlp_ratio),
            "fc2": _dense_spec(d * mlp_ratio, d)}


# ===========================================================================
# families
# ===========================================================================

def build_vgg(cfg):
    convs_per_stage = cfg.get("convs", [2, 2, 3, 3, 3])  # vgg16
    wm = cfg.get("width", 1.0)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    widths = [max(16, int(w * wm)) for w in (64, 128, 256, 512, 512)]

    specs: Dict[str, Any] = {}
    cin = 3
    for si, (n, cout) in enumerate(zip(convs_per_stage, widths)):
        for ci in range(n):
            specs[f"s{si}c{ci}"] = _conv_spec(cin, cout, 3)
            cin = cout
    feat = widths[-1] * (res // 2 ** len(widths)) ** 2
    specs["fc1"] = _dense_spec(feat, 4096)
    specs["fc2"] = _dense_spec(4096, 4096)
    specs["head"] = _dense_spec(4096, 1000)

    def fwd(p, x):
        for si, n in enumerate(convs_per_stage):
            for ci in range(n):
                x = torch.relu(conv(p[f"s{si}c{ci}"], x))
            x = maxpool(x)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(dense(p["fc1"], x))
        x = torch.relu(dense(p["fc2"], x))
        return dense(p["head"], x)

    return specs, fwd, {"family": "vgg", "batch": batch, "res": res}


def build_resnet(cfg):
    depths = cfg.get("depths", [2, 2, 2, 2])
    wm = cfg.get("width", 1.0)
    bottleneck = cfg.get("bottleneck", False)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    widths = [max(16, int(w * wm)) for w in (64, 128, 256, 512)]
    exp = 4 if bottleneck else 1

    specs: Dict[str, Any] = {"stem": _conv_spec(3, widths[0], 7),
                             "stem_bn": _bn_spec(widths[0])}
    cin = widths[0]
    for si, (n, w) in enumerate(zip(depths, widths)):
        for bi in range(n):
            blk = {}
            if bottleneck:
                blk["c1"] = _conv_spec(cin, w, 1)
                blk["c2"] = _conv_spec(w, w, 3)
                blk["c3"] = _conv_spec(w, w * exp, 1)
                blk["bn1"], blk["bn2"], blk["bn3"] = (_bn_spec(w), _bn_spec(w),
                                                      _bn_spec(w * exp))
            else:
                blk["c1"] = _conv_spec(cin, w, 3)
                blk["c2"] = _conv_spec(w, w, 3)
                blk["bn1"], blk["bn2"] = _bn_spec(w), _bn_spec(w)
            if cin != w * exp:
                blk["proj"] = _conv_spec(cin, w * exp, 1)
            specs[f"s{si}b{bi}"] = blk
            cin = w * exp
    specs["head"] = _dense_spec(cin, 1000)

    def fwd(p, x):
        x = torch.relu(bn(p["stem_bn"], conv(p["stem"], x, stride=2)))
        x = maxpool(x, 3, 2)
        for si, n in enumerate(depths):
            for bi in range(n):
                blk = p[f"s{si}b{bi}"]
                stride = 2 if (bi == 0 and si > 0) else 1
                idn = x
                if bottleneck:
                    y = torch.relu(bn(blk["bn1"], conv(blk["c1"], x, 1)))
                    y = torch.relu(bn(blk["bn2"], conv(blk["c2"], y, stride)))
                    y = bn(blk["bn3"], conv(blk["c3"], y, 1))
                else:
                    y = torch.relu(bn(blk["bn1"], conv(blk["c1"], x, stride)))
                    y = bn(blk["bn2"], conv(blk["c2"], y, 1))
                if "proj" in blk:
                    idn = conv(blk["proj"], x, stride)
                elif stride != 1:
                    idn = avgpool(x, stride, stride)
                x = torch.relu(y + idn)
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "resnet", "batch": batch, "res": res}


def build_densenet(cfg):
    blocks = cfg.get("blocks", [6, 12, 24, 16])   # densenet121
    growth = cfg.get("growth", 32)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)

    specs: Dict[str, Any] = {"stem": _conv_spec(3, 2 * growth, 7),
                             "stem_bn": _bn_spec(2 * growth)}
    c = 2 * growth
    for si, n in enumerate(blocks):
        for bi in range(n):
            specs[f"s{si}b{bi}"] = {
                "bn1": _bn_spec(c), "c1": _conv_spec(c, 4 * growth, 1),
                "bn2": _bn_spec(4 * growth),
                "c2": _conv_spec(4 * growth, growth, 3)}
            c += growth
        if si < len(blocks) - 1:
            specs[f"t{si}"] = {"bn": _bn_spec(c), "c": _conv_spec(c, c // 2, 1)}
            c = c // 2
    specs["final_bn"] = _bn_spec(c)
    specs["head"] = _dense_spec(c, 1000)

    def fwd(p, x):
        x = torch.relu(bn(p["stem_bn"], conv(p["stem"], x, 2)))
        x = maxpool(x, 3, 2)
        for si, n in enumerate(blocks):
            for bi in range(n):
                blk = p[f"s{si}b{bi}"]
                y = conv(blk["c1"], torch.relu(bn(blk["bn1"], x)), 1)
                y = conv(blk["c2"], torch.relu(bn(blk["bn2"], y)), 1)
                x = torch.cat([x, y], dim=-1)
            if si < len(blocks) - 1:
                t = p[f"t{si}"]
                x = conv(t["c"], torch.relu(bn(t["bn"], x)), 1)
                x = avgpool(x)
        x = torch.relu(bn(p["final_bn"], x))
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "densenet", "batch": batch, "res": res}


def _inv_residual_specs(cin, cout, expand, k):
    mid = cin * expand
    return {"e": _conv_spec(cin, mid, 1), "ebn": _bn_spec(mid),
            "dw": _dw_spec(mid, k), "dwbn": _bn_spec(mid),
            "p": _conv_spec(mid, cout, 1), "pbn": _bn_spec(cout)}


def _inv_residual(p, x, stride, use_res):
    y = relu6(bn(p["ebn"], conv(p["e"], x, 1)))
    y = relu6(bn(p["dwbn"], dwconv(p["dw"], y, stride)))
    y = bn(p["pbn"], conv(p["p"], y, 1))
    return x + y if use_res else y


def build_mobilenet(cfg):
    # MobileNetV2-style inverted residuals
    wm = cfg.get("width", 1.0)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    settings = cfg.get("settings", [
        # (expand, cout, n, stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)])
    def ch(c): return max(8, int(c * wm))

    specs: Dict[str, Any] = {"stem": _conv_spec(3, ch(32), 3),
                             "stem_bn": _bn_spec(ch(32))}
    cin = ch(32)
    for si, (e, c, n, s0) in enumerate(settings):
        for bi in range(n):
            specs[f"s{si}b{bi}"] = _inv_residual_specs(cin, ch(c), e, 3)
            cin = ch(c)
    specs["last"] = _conv_spec(cin, ch(1280), 1)
    specs["last_bn"] = _bn_spec(ch(1280))
    specs["head"] = _dense_spec(ch(1280), 1000)

    def fwd(p, x):
        x = relu6(bn(p["stem_bn"], conv(p["stem"], x, 2)))
        cin_l = ch(32)
        for si, (e, c, n, s0) in enumerate(settings):
            for bi in range(n):
                stride = s0 if bi == 0 else 1
                use_res = stride == 1 and cin_l == ch(c)
                x = _inv_residual(p[f"s{si}b{bi}"], x, stride, use_res)
                cin_l = ch(c)
        x = relu6(bn(p["last_bn"], conv(p["last"], x, 1)))
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "mobilenet", "batch": batch, "res": res}


def build_mnasnet(cfg):
    wm = cfg.get("width", 1.0)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    settings = cfg.get("settings", [
        (3, 24, 3, 2, 3), (3, 40, 3, 2, 5), (6, 80, 3, 2, 5),
        (6, 96, 2, 1, 3), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)])
    def ch(c): return max(8, int(c * wm))

    specs: Dict[str, Any] = {"stem": _conv_spec(3, ch(32), 3),
                             "stem_bn": _bn_spec(ch(32)),
                             "sep_dw": _dw_spec(ch(32), 3),
                             "sep_bn": _bn_spec(ch(32)),
                             "sep_p": _conv_spec(ch(32), ch(16), 1),
                             "sep_pbn": _bn_spec(ch(16))}
    cin = ch(16)
    for si, (e, c, n, s0, k) in enumerate(settings):
        for bi in range(n):
            specs[f"s{si}b{bi}"] = _inv_residual_specs(cin, ch(c), e, k)
            cin = ch(c)
    specs["head"] = _dense_spec(cin, 1000)

    def fwd(p, x):
        x = torch.relu(bn(p["stem_bn"], conv(p["stem"], x, 2)))
        x = torch.relu(bn(p["sep_bn"], dwconv(p["sep_dw"], x, 1)))
        x = bn(p["sep_pbn"], conv(p["sep_p"], x, 1))
        cin_l = ch(16)
        for si, (e, c, n, s0, k) in enumerate(settings):
            for bi in range(n):
                stride = s0 if bi == 0 else 1
                use_res = stride == 1 and cin_l == ch(c)
                x = _inv_residual(p[f"s{si}b{bi}"], x, stride, use_res)
                cin_l = ch(c)
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "mnasnet", "batch": batch, "res": res}


def build_efficientnet(cfg):
    wm = cfg.get("width", 1.0)
    dm = cfg.get("depth", 1.0)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    base = [  # (expand, cout, n, stride, k)
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3)]
    def ch(c): return max(8, int(c * wm))
    def rep(n): return max(1, int(round(n * dm)))

    specs: Dict[str, Any] = {"stem": _conv_spec(3, ch(32), 3),
                             "stem_bn": _bn_spec(ch(32))}
    cin = ch(32)
    for si, (e, c, n, s0, k) in enumerate(base):
        for bi in range(rep(n)):
            blk = _inv_residual_specs(cin, ch(c), e, k)
            mid = cin * e
            sq = max(1, cin // 4)
            blk["se1"] = _dense_spec(mid, sq)
            blk["se2"] = _dense_spec(sq, mid)
            specs[f"s{si}b{bi}"] = blk
            cin = ch(c)
    specs["last"] = _conv_spec(cin, ch(1280), 1)
    specs["last_bn"] = _bn_spec(ch(1280))
    specs["head"] = _dense_spec(ch(1280), 1000)

    def mbconv_se(p, x, stride, use_res):
        y = silu(bn(p["ebn"], conv(p["e"], x, 1)))
        y = silu(bn(p["dwbn"], dwconv(p["dw"], y, stride)))
        s = gap(y)
        s = silu(dense(p["se1"], s))
        s = torch.sigmoid(dense(p["se2"], s))
        # one reshape, as the reference's s[:, None, None, :] is one
        # broadcast_in_dim
        y = y * s.reshape(s.shape[0], 1, 1, s.shape[1])
        y = bn(p["pbn"], conv(p["p"], y, 1))
        return x + y if use_res else y

    def fwd(p, x):
        x = silu(bn(p["stem_bn"], conv(p["stem"], x, 2)))
        cin_l = ch(32)
        for si, (e, c, n, s0, k) in enumerate(base):
            for bi in range(rep(n)):
                stride = s0 if bi == 0 else 1
                use_res = stride == 1 and cin_l == ch(c)
                x = mbconv_se(p[f"s{si}b{bi}"], x, stride, use_res)
                cin_l = ch(c)
        x = silu(bn(p["last_bn"], conv(p["last"], x, 1)))
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "efficientnet", "batch": batch, "res": res}


def build_vit(cfg):
    d = cfg.get("dim", 768)
    depth = cfg.get("depth", 12)
    heads = cfg.get("heads", max(1, d // 64))
    patch = cfg.get("patch", 16)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    n_tok = (res // patch) ** 2

    specs: Dict[str, Any] = {
        "embed": _conv_spec(3, d, patch),
        "pos": S(1, n_tok, d),
        "final_ln": _ln_spec(d),
        "head": _dense_spec(d, 1000)}
    for i in range(depth):
        specs[f"blk{i}"] = _tx_spec(d)

    def fwd(p, x):
        x = conv(p["embed"], x, patch, padding="VALID")
        x = _tokens(x) + p["pos"]
        for i in range(depth):
            x = tx_block(p[f"blk{i}"], x, heads)
        x = ln(p["final_ln"], x)
        return dense(p["head"], x.sum(1) / x.shape[1])

    return specs, fwd, {"family": "vit", "batch": batch, "res": res}


def build_swin(cfg):
    d = cfg.get("dim", 96)
    depths = cfg.get("depths", [2, 2, 6, 2])
    window = cfg.get("window", 7)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    patch = 4

    specs: Dict[str, Any] = {"embed": _conv_spec(3, d, patch)}
    dim = d
    for si, n in enumerate(depths):
        for bi in range(n):
            specs[f"s{si}b{bi}"] = _tx_spec(dim)
        if si < len(depths) - 1:
            specs[f"merge{si}"] = _dense_spec(4 * dim, 2 * dim, bias=False)
            dim *= 2
    specs["final_ln"] = _ln_spec(dim)
    specs["head"] = _dense_spec(dim, 1000)

    def win_attn_block(p, x, hw, dim_l):
        B = x.shape[0]
        H = W = hw
        heads = max(1, dim_l // 32)
        # partition into windows → attention within windows
        xw = x.reshape(B, H // window, window, W // window, window, dim_l)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, dim_l)
        xw = tx_block(p, xw, heads)
        xw = xw.reshape(B, H // window, W // window, window, window, dim_l)
        return xw.permute(0, 1, 3, 2, 4, 5).reshape(B, H * W, dim_l)

    def fwd(p, x):
        x = conv(p["embed"], x, patch, padding="VALID")
        B, hw = x.shape[0], x.shape[1]
        dim_l = d
        x = _tokens(x)
        for si, n in enumerate(depths):
            for bi in range(n):
                x = win_attn_block(p[f"s{si}b{bi}"], x, hw, dim_l)
            if si < len(depths) - 1:
                # patch merging: 2x2 neighborhood concat + linear
                x = x.reshape(B, hw // 2, 2, hw // 2, 2, dim_l)
                x = x.permute(0, 1, 3, 2, 4, 5).reshape(
                    B, (hw // 2) ** 2, 4 * dim_l)
                x = dense(p[f"merge{si}"], x)
                dim_l *= 2
                hw //= 2
        x = ln(p["final_ln"], x)
        return dense(p["head"], x.sum(1) / x.shape[1])

    return specs, fwd, {"family": "swin", "batch": batch, "res": res}


def build_visformer(cfg):
    d = cfg.get("dim", 384)
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    conv_depth = cfg.get("conv_depth", 4)
    tx_depth = cfg.get("tx_depth", 4)
    heads = max(1, d // 64)

    specs: Dict[str, Any] = {"stem": _conv_spec(3, d // 4, 7),
                             "stem_bn": _bn_spec(d // 4)}
    c = d // 4
    for i in range(conv_depth):
        specs[f"conv{i}"] = {"c1": _conv_spec(c, c, 3), "bn1": _bn_spec(c),
                             "c2": _conv_spec(c, c, 3), "bn2": _bn_spec(c)}
    specs["proj"] = _conv_spec(c, d, 2)
    for i in range(tx_depth):
        specs[f"blk{i}"] = _tx_spec(d)
    specs["final_ln"] = _ln_spec(d)
    specs["head"] = _dense_spec(d, 1000)

    def fwd(p, x):
        x = torch.relu(bn(p["stem_bn"], conv(p["stem"], x, 2)))
        x = maxpool(x)
        for i in range(conv_depth):
            blk = p[f"conv{i}"]
            y = torch.relu(bn(blk["bn1"], conv(blk["c1"], x)))
            y = bn(blk["bn2"], conv(blk["c2"], y))
            x = torch.relu(x + y)
        x = _tokens(conv(p["proj"], x, 2, padding="VALID"))
        for i in range(tx_depth):
            x = tx_block(p[f"blk{i}"], x, heads)
        x = ln(p["final_ln"], x)
        return dense(p["head"], x.sum(1) / x.shape[1])

    return specs, fwd, {"family": "visformer", "batch": batch, "res": res}


def build_poolformer(cfg):
    d = cfg.get("dim", 64)
    depths = cfg.get("depths", [2, 2, 6, 2])
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)

    dims = [d, d * 2, d * 4, d * 8]
    specs: Dict[str, Any] = {"embed": _conv_spec(3, dims[0], 7)}
    for si, n in enumerate(depths):
        dim = dims[si]
        for bi in range(n):
            specs[f"s{si}b{bi}"] = {
                "ln1": _bn_spec(dim), "ln2": _bn_spec(dim),
                "fc1": _conv_spec(dim, dim * 4, 1),
                "fc2": _conv_spec(dim * 4, dim, 1)}
        if si < len(depths) - 1:
            specs[f"down{si}"] = _conv_spec(dim, dims[si + 1], 3)
    specs["head"] = _dense_spec(dims[-1], 1000)

    def fwd(p, x):
        x = conv(p["embed"], x, 4)
        for si, n in enumerate(depths):
            for bi in range(n):
                blk = p[f"s{si}b{bi}"]
                # token mixer: pooling - identity
                y = bn(blk["ln1"], x)
                y = avgpool(y, 3, 1) - y
                x = x + y
                y = bn(blk["ln2"], x)
                y = gelu(conv(blk["fc1"], y, 1))
                x = x + conv(blk["fc2"], y, 1)
            if si < len(depths) - 1:
                x = conv(p[f"down{si}"], x, 2)
        return dense(p["head"], gap(x))

    return specs, fwd, {"family": "poolformer", "batch": batch, "res": res}


def build_convnext(cfg):
    """Held-out family — used only for the Table-5 'unseen' evaluation."""
    d = cfg.get("dim", 128)
    depths = cfg.get("depths", [3, 3, 9, 3])
    res, batch = cfg.get("res", 224), cfg.get("batch", 1)
    dims = [d, d * 2, d * 4, d * 8]

    specs: Dict[str, Any] = {"stem": _conv_spec(3, dims[0], 4)}
    for si, n in enumerate(depths):
        dim = dims[si]
        for bi in range(n):
            specs[f"s{si}b{bi}"] = {
                "dw": _dw_spec(dim, 7), "ln": _ln_spec(dim),
                "fc1": _dense_spec(dim, 4 * dim),
                "fc2": _dense_spec(4 * dim, dim)}
        if si < len(depths) - 1:
            specs[f"down{si}"] = _conv_spec(dim, dims[si + 1], 2)
    specs["final_ln"] = _ln_spec(dims[-1])
    specs["head"] = _dense_spec(dims[-1], 1000)

    def fwd(p, x):
        x = conv(p["stem"], x, 4, padding="VALID")
        for si, n in enumerate(depths):
            for bi in range(n):
                blk = p[f"s{si}b{bi}"]
                y = dwconv(blk["dw"], x, 1)
                y = ln(blk["ln"], y)
                y = gelu(dense(blk["fc1"], y))
                y = dense(blk["fc2"], y)
                x = x + y
            if si < len(depths) - 1:
                x = conv(p[f"down{si}"], x, 2, padding="VALID")
        x = ln(p["final_ln"], gap(x)[:, None, :])[:, 0]
        return dense(p["head"], x)

    return specs, fwd, {"family": "convnext", "batch": batch, "res": res}


FAMILIES: Dict[str, Callable] = {
    "efficientnet": build_efficientnet,
    "mnasnet": build_mnasnet,
    "mobilenet": build_mobilenet,
    "resnet": build_resnet,
    "vgg": build_vgg,
    "swin": build_swin,
    "vit": build_vit,
    "densenet": build_densenet,
    "visformer": build_visformer,
    "poolformer": build_poolformer,
    "convnext": build_convnext,   # held out of training (Table 5 'unseen')
}

#: Table 2 distribution (family → fraction of the 10,508 graphs)
TABLE2_FRACTIONS: Dict[str, float] = {
    "efficientnet": 0.1645, "mnasnet": 0.0953, "mobilenet": 0.1514,
    "resnet": 0.1096, "vgg": 0.1462, "swin": 0.0521, "vit": 0.0495,
    "densenet": 0.0731, "visformer": 0.0731, "poolformer": 0.0853,
}


def family_variants(family: str, rng) -> Dict[str, Any]:
    """Sample one variant config for a family (seeded numpy ``Generator``;
    the same draws as the reference's for the same generator state)."""
    batch = int(rng.choice([1, 2, 4, 8, 16, 32, 64]))
    res = int(rng.choice([128, 160, 192, 224, 256]))
    cfg: Dict[str, Any] = {"batch": batch, "res": res}
    if family == "vgg":
        cfg["convs"] = list(rng.choice(
            [[1, 1, 2, 2, 2], [2, 2, 2, 2, 2], [2, 2, 3, 3, 3],
             [2, 2, 4, 4, 4]]))
        cfg["width"] = float(rng.choice([0.5, 0.75, 1.0]))
    elif family == "resnet":
        cfg["depths"] = list(rng.choice(
            [[2, 2, 2, 2], [3, 4, 6, 3], [2, 3, 4, 2]]))
        cfg["bottleneck"] = bool(rng.random() < 0.5)
        cfg["width"] = float(rng.choice([0.5, 0.75, 1.0]))
    elif family == "densenet":
        cfg["blocks"] = list(rng.choice(
            [[6, 12, 24, 16], [6, 12, 32, 32], [4, 8, 16, 12], [3, 6, 12, 8]]))
        cfg["growth"] = int(rng.choice([16, 24, 32]))
    elif family in ("mobilenet", "mnasnet"):
        cfg["width"] = float(rng.choice([0.35, 0.5, 0.75, 1.0, 1.4]))
    elif family == "efficientnet":
        cfg["width"] = float(rng.choice([0.75, 1.0, 1.1, 1.2]))
        cfg["depth"] = float(rng.choice([0.8, 1.0, 1.1, 1.2]))
    elif family == "vit":
        cfg["dim"] = int(rng.choice([192, 384, 768]))
        cfg["depth"] = int(rng.choice([6, 8, 12]))
        cfg["patch"] = int(rng.choice([16, 32]))
        cfg["res"] = 224
    elif family == "swin":
        cfg["dim"] = int(rng.choice([64, 96, 128]))
        cfg["depths"] = list(rng.choice([[2, 2, 6, 2], [2, 2, 2, 2]]))
        cfg["res"] = 224
    elif family == "visformer":
        cfg["dim"] = int(rng.choice([192, 384]))
        cfg["conv_depth"] = int(rng.choice([2, 4, 6]))
        cfg["tx_depth"] = int(rng.choice([2, 4, 6]))
    elif family == "poolformer":
        cfg["dim"] = int(rng.choice([32, 48, 64, 96]))
        cfg["depths"] = list(rng.choice([[2, 2, 6, 2], [4, 4, 12, 4]]))
    elif family == "convnext":
        cfg["dim"] = int(rng.choice([96, 128]))
        cfg["depths"] = list(rng.choice([[3, 3, 9, 3], [2, 2, 6, 2]]))
    return cfg


def build_family(family: str, cfg: Dict[str, Any]):
    """→ (param_specs, forward, meta). ``meta`` includes batch/res/family."""
    specs, fwd, meta = FAMILIES[family](cfg)
    meta.update({k: v for k, v in cfg.items() if k not in meta})
    return specs, fwd, meta


def trace_family(family: str, cfg: Dict[str, Any]):
    """Build one family variant and trace it into an ``OpGraph``.

    The standard image input spec ``[batch, res, res, 3]`` is derived from
    ``cfg`` (defaults: batch 1, res 224). This is the zoo→predictor glue
    used by the dataset builder and ``DIPPM.predict_zoo``.
    """
    from ..core.frontends import from_torch
    specs, fwd, meta = build_family(family, cfg)
    batch = int(cfg.get("batch", 1))
    res = int(cfg.get("res", 224))
    return from_torch(fwd, specs, ((batch, res, res, 3), F32), meta=meta)


def variant_grid(family: str,
                 axes: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of config axes → list of variant configs.

        variant_grid("vit", {"depth": [6, 12], "dim": [192, 384],
                             "batch": [1, 8]})

    yields 8 configs ready for :func:`build_family` / ``predict_zoo``.
    ``family`` is only validated (KeyError on unknown family); axes are
    passed through untouched.
    """
    if family not in FAMILIES:
        raise KeyError(f"unknown zoo family: {family!r}")
    keys = list(axes)
    out: List[Dict[str, Any]] = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out
