"""Image ops: the ``mx.nd.image`` namespace (PyTorch counterpart of
``mxnet_tpu/ops/image_ops.py``).

CHW (or NCHW) float values in [0, 255], RGB order: ``to_tensor``,
``normalize``, the flips, brightness, contrast, saturation, hue, PCA
lighting, colour jitter, ``resize`` and ``crop``.  Integer images come
back in their own dtype through a saturating round (:func:`_cast_like`).

The random ops draw from the key they are given (``rng_key``, one draw of
the stream a call): the scalars are ``jax.random.uniform``/``bernoulli``/
``normal`` bit for bit (``random_ops``), and ``random_color_jitter``'s
order is ``jax.random.permutation`` of four (one sort of 32-bit keys).

:func:`scale_resize` is ``jax.image.resize``: per resized axis a weight
matrix (a triangle or Keys-cubic filter at half-pixel centres, widened
when shrinking, renormalized, zero past the border) contracted with the
image, and ``nearest`` a gather at ``floor((i + 0.5) * m / n)``; integer
images come back float32 from the filters and in their own dtype from
``nearest``.  The host helpers of ``image.py``, ``nd.imresize`` and
``_cvimresize`` resize through it.
"""
from __future__ import annotations

import torch

from .random_ops import _uniform, bernoulli_mask, random_normal, uniform_bits
from .registry import register
from .sampling import threefry2x32

__all__ = ["to_tensor", "normalize", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom",
           "random_brightness", "random_contrast", "random_saturation",
           "resize", "crop", "random_hue", "adjust_lighting",
           "random_lighting", "random_color_jitter", "scale_resize"]

_EPS32 = 1.1920928955078125e-07


# ---------------------------------------------------------------------------
# jax.image.resize
# ---------------------------------------------------------------------------

def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _weight_mat(m, n, kernel, device):
    """``compute_weight_mat(m, n, n / m, 0, kernel, antialias=True)``:
    (m, n) float32."""
    inv_scale = 1.0 / (n / m) if n else 1.0
    f32 = torch.float32
    kernel_scale = max(float(torch.tensor(inv_scale, dtype=f32)), 1.0)
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * \
        torch.tensor(inv_scale, dtype=f32, device=device) - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def scale_resize(x, shape, method="linear"):
    """``jax.image.resize(x, shape, method)`` (antialiased) for
    ``method`` in ``linear``/``bilinear``, ``cubic``/``bicubic`` and
    ``nearest``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {shape} does not match the "
                         f"image's rank {x.ndim}")
    dims = [d for d in range(x.ndim) if x.shape[d] != shape[d]]
    if method == "nearest":
        for d in dims:
            m, n = x.shape[d], shape[d]
            off = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * float(m) / float(n)
            x = x.index_select(d, torch.floor(off).to(torch.int64))
        return x
    kernel = {"linear": _triangle, "bilinear": _triangle,
              "cubic": _keys_cubic, "bicubic": _keys_cubic}[method]
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    for d in dims:
        w = _weight_mat(x.shape[d], shape[d], kernel, x.device)
        x = torch.tensordot(x, w.to(x.dtype), dims=([d], [0])).movedim(-1, d)
    return x


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------

@register("_image_to_tensor")
def to_tensor(data):
    """HWC (NHWC) values in [0, 255] -> CHW (NCHW) float32 in [0, 1]
    (times the float32 reciprocal of 255, as XLA divides by a
    constant)."""
    x = data.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                              dtype=torch.float32)
    if x.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize")
def normalize(data, mean=(0.0,), std=(1.0,)):
    """``(x - mean) / std`` over the channel axis of CHW or NCHW."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=data.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=data.device)
    shape = (1, -1, 1, 1) if data.ndim == 4 else (-1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register("_image_flip_left_right")
def flip_left_right(data):
    return torch.flip(data, dims=[-1])


@register("_image_flip_top_bottom")
def flip_top_bottom(data):
    return torch.flip(data, dims=[-2])


@register("_image_random_flip_left_right", rng=True, differentiable=False)
def random_flip_left_right(data, rng_key=None, p=0.5):
    do = bernoulli_mask(rng_key, float(p), ())
    return torch.where(do, torch.flip(data, dims=[-1]), data)


@register("_image_random_flip_top_bottom", rng=True, differentiable=False)
def random_flip_top_bottom(data, rng_key=None, p=0.5):
    do = bernoulli_mask(rng_key, float(p), ())
    return torch.where(do, torch.flip(data, dims=[-2]), data)


_LUMA = (0.299, 0.587, 0.114)
# eigvec * eigval of the ImageNet RGB covariance (AlexNet's PCA lighting)
_LIGHTING_EIG = (
    (55.46 * -0.5675, 4.794 * 0.7192, 1.148 * 0.4009),
    (55.46 * -0.5808, 4.794 * -0.0045, 1.148 * -0.8140),
    (55.46 * -0.5836, 4.794 * -0.6948, 1.148 * 0.4203),
)


def _luma(device):
    return torch.tensor(_LUMA, dtype=torch.float32,
                        device=device).reshape(3, 1, 1)


def _cast_like(out_f, data):
    """A float result in ``data``'s dtype: integer images saturate after a
    round half to even (a bare cast would wrap a uint8 shift)."""
    if data.dtype.is_floating_point:
        return out_f.to(data.dtype)
    info = torch.iinfo(data.dtype)
    return torch.clamp(torch.round(out_f), info.min, info.max).to(data.dtype)


def _gray_mean(x):
    """The scalar luma mean of each CHW image, shaped to broadcast."""
    return (x * _luma(x.device)).sum(dim=-3).mean(
        dim=(-1, -2), keepdim=True)[..., None, :, :]


@register("_image_random_brightness", rng=True, differentiable=False)
def random_brightness(data, min_factor=0.5, max_factor=1.5, rng_key=None):
    f = _uniform(rng_key, (), float(min_factor), float(max_factor))
    return _cast_like(data.to(torch.float32) * f, data)


@register("_image_random_contrast", rng=True, differentiable=False)
def random_contrast(data, min_factor=0.5, max_factor=1.5, rng_key=None):
    f = _uniform(rng_key, (), float(min_factor), float(max_factor))
    xf = data.to(torch.float32)
    return _cast_like(xf * f + (1.0 - f) * _gray_mean(xf), data)


@register("_image_random_saturation", rng=True, differentiable=False)
def random_saturation(data, min_factor=0.5, max_factor=1.5, rng_key=None):
    f = _uniform(rng_key, (), float(min_factor), float(max_factor))
    xf = data.to(torch.float32)
    gray = (xf * _luma(xf.device)).sum(dim=-3, keepdim=True)
    return _cast_like(xf * f + gray * (1.0 - f), data)


@register("_image_resize")
def resize(data, size=0, keep_ratio=False, interp=1):
    """Resize CHW or NCHW to ``size`` (an int, or ``(w, h)``); an int with
    ``keep_ratio`` sets the short side, keeping the aspect ratio."""
    if isinstance(size, (tuple, list)):
        w, h = int(size[0]), int(size[1])
    elif keep_ratio:
        ih, iw = data.shape[-2], data.shape[-1]
        if ih <= iw:
            h = int(size)
            w = max(1, round(iw * int(size) / ih))
        else:
            w = int(size)
            h = max(1, round(ih * int(size) / iw))
    else:
        w = h = int(size)
    chw = data.ndim == 3
    x = data[None] if chw else data
    out = scale_resize(x, (x.shape[0], x.shape[1], h, w),
                       "bilinear" if interp else "nearest")
    return out[0] if chw else out


@register("_image_crop")
def crop(data, x=0, y=0, width=0, height=0):
    """The ``height`` x ``width`` window at (``x``, ``y``) of CHW/NCHW."""
    x, y, width, height = int(x), int(y), int(width), int(height)
    if data.ndim == 3:
        return data[:, y:y + height, x:x + width]
    return data[:, :, y:y + height, x:x + width]


def _adjust_hue(data, alpha):
    """RGB -> HLS, hue += ``alpha`` turns, -> RGB; values in [0, 255]."""
    r, g, b = (data[..., i, :, :] / 255.0 for i in range(3))
    cmax = torch.maximum(torch.maximum(r, g), b)
    cmin = torch.minimum(torch.minimum(r, g), b)
    c = cmax - cmin
    zero = torch.zeros_like(c)
    safe_c = torch.where(c == 0, torch.ones_like(c), c)
    hp = torch.where(cmax == r, torch.remainder((g - b) / safe_c, 6.0),
                     torch.where(cmax == g, (b - r) / safe_c + 2.0,
                                 (r - g) / safe_c + 4.0))
    hp = torch.where(c == 0, zero, hp)
    lum = (cmax + cmin) / 2.0
    sat = torch.where(c == 0, zero, c / torch.clamp(
        1.0 - (2.0 * lum - 1.0).abs(), min=1e-12))
    hp = torch.remainder(hp + alpha * 6.0, 6.0)
    cc = (1.0 - (2.0 * lum - 1.0).abs()) * sat
    xx = cc * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    m = lum - cc / 2.0
    sector = torch.clamp(hp.to(torch.int32), 0, 5)

    def select(vals):
        out = vals[5]
        for s in (4, 3, 2, 1, 0):
            out = torch.where(sector == s, vals[s], out)
        return out

    r1 = select([cc, xx, zero, zero, xx, cc])
    g1 = select([xx, cc, cc, xx, zero, zero])
    b1 = select([zero, zero, xx, cc, cc, xx])
    out = torch.stack([r1 + m, g1 + m, b1 + m], dim=-3) * 255.0
    return _cast_like(out, data)


@register("_image_random_hue", rng=True, differentiable=False)
def random_hue(data, min_factor=-0.1, max_factor=0.1, rng_key=None):
    alpha = _uniform(rng_key, (), float(min_factor), float(max_factor))
    return _adjust_hue(data, alpha)


def _lighting(data, alpha):
    eig = torch.tensor(_LIGHTING_EIG, dtype=torch.float32,
                       device=data.device)
    pca = eig @ alpha
    return _cast_like(data.to(torch.float32) + pca.reshape(3, 1, 1), data)


@register("_image_adjust_lighting")
def adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet's PCA lighting shift of each RGB channel."""
    return _lighting(data, torch.as_tensor(alpha, dtype=torch.float32,
                                           device=data.device))


@register("_image_random_lighting", rng=True, differentiable=False)
def random_lighting(data, alpha_std=0.05, rng_key=None):
    alpha = random_normal(rng_key, shape=(3,)) * float(alpha_std)
    return _lighting(data, alpha)


def _split(key, n):
    """``jax.random.split(key, n)`` of an int64 key tensor: (n, 2)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)
    return torch.stack([k0, k1], dim=-1)


def _permutation(key, n):
    """``jax.random.permutation(key, n)`` for n below 2**10: one stable
    sort of 32-bit keys drawn from the key's second split."""
    sort_keys = uniform_bits(_split(key, 2)[1], (n,))
    return torch.argsort(sort_keys, stable=True)


@register("_image_random_color_jitter", rng=True, differentiable=False)
def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0, rng_key=None):
    """Brightness, contrast, saturation and hue jitter in a random order
    (the reference's shuffled adjusters; the gray means use the luma).
    The order is read on the host, so a hybridized block's program that
    runs this op stays uncaptured."""
    from ..gluon import cached_op

    cached_op.note_host_sync("_image_random_color_jitter")
    keys = _split(rng_key, 5)
    order = _permutation(keys[0], 4).tolist()
    b, c, s, h = (float(v) for v in (brightness, contrast, saturation, hue))
    alpha_b = 1.0 + _uniform(keys[1], (), -b, b or 1e-9)
    alpha_c = 1.0 + _uniform(keys[2], (), -c, c or 1e-9)
    alpha_s = 1.0 + _uniform(keys[3], (), -s, s or 1e-9)
    alpha_h = _uniform(keys[4], (), -h, h or 1e-9)

    def do_brightness(x):
        return x * alpha_b if b > 0 else x

    def do_contrast(x):
        return x * alpha_c + (1.0 - alpha_c) * _gray_mean(x) if c > 0 else x

    def do_saturation(x):
        if s <= 0:
            return x
        gray = (x * _luma(x.device)).sum(dim=-3, keepdim=True)
        return x * alpha_s + (1.0 - alpha_s) * gray

    def do_hue(x):
        return _adjust_hue(x, alpha_h) if h > 0 else x

    branches = (do_brightness, do_contrast, do_saturation, do_hue)
    out = data.to(torch.float32)
    for i in order:
        out = branches[i](out)
    return _cast_like(out, data)
