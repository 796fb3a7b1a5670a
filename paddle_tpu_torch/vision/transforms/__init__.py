"""paddle.vision.transforms (reference: python/paddle/vision/transforms) — numpy-based."""
from __future__ import annotations

import numpy as np

from ...core.tensor import Tensor


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[None] if self.data_format == "CHW" else arr[..., None]
        elif self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, img):
        import torch
        from ...nn.functional.common import _linear_kernel, _resize_axis
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        h_ax, w_ax = (1, 2) if chw else (0, 1)
        # jax.image.resize(..., "linear"): triangle weights, antialiased
        # when downsampling, on each axis whose size changes
        out = torch.from_numpy(arr)
        for ax, n in zip((h_ax, w_ax), self.size):
            if out.shape[ax] != n:
                out = _resize_axis(out, ax, n, _linear_kernel)
        return out.numpy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            arr = np.asarray(img)
            return arr[..., ::-1].copy() if arr.ndim == 3 and arr.shape[0] in (1, 3) \
                else arr[:, ::-1].copy()
        return img


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if self.padding:
            pads = [(0, 0), (self.padding, self.padding), (self.padding, self.padding)] \
                if chw else [(self.padding, self.padding), (self.padding, self.padding)] + \
                ([(0, 0)] if arr.ndim == 3 else [])
            arr = np.pad(arr, pads, mode="constant")
        h_ax = 1 if chw else 0
        h, w = arr.shape[h_ax], arr.shape[h_ax + 1]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        if chw:
            return arr[:, i:i + th, j:j + tw]
        return arr[i:i + th, j:j + tw]


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


# ---- round-2 additions: the rest of the reference transform set -------------
def _axes(arr):
    """(h_axis, w_axis, chw?) for a 2D/3D image array."""
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return (1, 2, True) if chw else (0, 1, False)


def hflip(img):
    arr = np.asarray(img)
    h, w, chw = _axes(arr)
    return np.flip(arr, axis=w).copy()


def vflip(img):
    arr = np.asarray(img)
    h, w, chw = _axes(arr)
    return np.flip(arr, axis=h).copy()


def crop(img, top, left, height, width):
    arr = np.asarray(img)
    h, w, chw = _axes(arr)
    sl = [slice(None)] * arr.ndim
    sl[h] = slice(top, top + height)
    sl[w] = slice(left, left + width)
    return arr[tuple(sl)]


def center_crop(img, output_size):
    size = output_size if isinstance(output_size, (list, tuple)) else \
        (output_size, output_size)
    arr = np.asarray(img)
    h, w, chw = _axes(arr)
    th, tw = size
    top = max(0, (arr.shape[h] - th) // 2)
    left = max(0, (arr.shape[w] - tw) // 2)
    return crop(arr, top, left, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = np.asarray(img)
    if isinstance(padding, int):
        pl = pr = pt = pb = padding
    elif len(padding) == 2:         # (left/right, top/bottom)
        pl = pr = padding[0]
        pt = pb = padding[1]
    else:
        pl, pt, pr, pb = padding
    h, w, chw = _axes(arr)
    pads = [(0, 0)] * arr.ndim
    pads[h] = (pt, pb)
    pads[w] = (pl, pr)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(arr, pads, mode=mode, **kw)


def _value_range(img):
    """Max representable value from DTYPE (not data): integers use their
    type's range, floats are 0..1 by convention (PIL/reference)."""
    dt = np.asarray(img).dtype
    return float(np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0


def _restore_dtype(out, like):
    dt = np.asarray(like).dtype
    return out.astype(dt) if np.issubdtype(dt, np.integer) else out


def adjust_brightness(img, brightness_factor):
    hi = _value_range(img)
    arr = np.asarray(img, np.float32)
    return _restore_dtype(np.clip(arr * brightness_factor, 0, hi), img)


def adjust_contrast(img, contrast_factor):
    hi = _value_range(img)
    arr = np.asarray(img, np.float32)
    mean = arr.mean()
    return _restore_dtype(
        np.clip((arr - mean) * contrast_factor + mean, 0, hi), img)


_GRAY_WGT = np.array([0.299, 0.587, 0.114], np.float32)


def _luminance(arr, chw):
    """Weighted gray over the channel axis; 1-chan passes through, RGBA uses
    the RGB channels."""
    c_ax = 0 if chw else -1
    nc = arr.shape[c_ax]
    if nc == 1:
        return np.take(arr, 0, axis=c_ax)
    rgb = np.take(arr, [0, 1, 2], axis=c_ax) if nc == 4 else arr
    if chw:
        return np.tensordot(_GRAY_WGT, rgb, axes=([0], [0]))
    return rgb @ _GRAY_WGT


def adjust_saturation(img, saturation_factor):
    hi = _value_range(img)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        return _restore_dtype(arr, img)
    h, w, chw = _axes(arr)
    gray = np.expand_dims(_luminance(arr, chw), 0 if chw else -1)
    return _restore_dtype(
        np.clip(gray + (arr - gray) * saturation_factor, 0, hi), img)


def to_grayscale(img, num_output_channels=1):
    arr = np.asarray(img, np.float32)
    h, w, chw = _axes(arr)
    g = arr if arr.ndim == 2 else _luminance(arr, chw)
    g = _restore_dtype(g, img)
    if num_output_channels == 1:
        return g[None] if chw or arr.ndim == 2 else g[..., None]
    rep = [g] * num_output_channels
    return np.stack(rep, axis=0 if (chw or arr.ndim == 2) else -1)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    from scipy import ndimage
    arr = np.asarray(img, np.float32)
    h, w, chw = _axes(arr)
    order = {"nearest": 0, "bilinear": 1}[interpolation]
    return ndimage.rotate(arr, -angle, axes=(w, h), reshape=expand,
                          order=order, cval=fill)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        return vflip(img) if np.random.rand() < self.prob else img


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.args = (padding, fill, padding_mode)

    def __call__(self, img):
        return pad(img, *self.args)


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.n)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        f = 1 + np.random.uniform(-self.value, self.value)
        return adjust_brightness(img, f)


class ContrastTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        f = 1 + np.random.uniform(-self.value, self.value)
        return adjust_contrast(img, f)


class SaturationTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        f = 1 + np.random.uniform(-self.value, self.value)
        return adjust_saturation(img, f)


class ColorJitter:
    """brightness/contrast/saturation jitter (reference transforms.ColorJitter;
    hue omitted: needs HSV round-trip the reference does via PIL)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation)]

    def __call__(self, img):
        for t in np.random.permutation(self.ts):
            img = t(img)
        return img


class RandomRotation:
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.kw = dict(interpolation=interpolation, expand=expand,
                       center=center, fill=fill)

    def __call__(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, **self.kw)


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def __call__(self, img):
        arr = np.asarray(img)
        h, w, chw = _axes(arr)
        H, W = arr.shape[h], arr.shape[w]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= W and ch <= H:
                top = np.random.randint(0, H - ch + 1)
                left = np.random.randint(0, W - cw + 1)
                patch = crop(arr, top, left, ch, cw)
                return Resize(self.size, self.interpolation)(patch)
        return Resize(self.size, self.interpolation)(center_crop(
            arr, (min(H, W), min(H, W))))


# ---- round-2 completion (reference vision/transforms/transforms.py) ----------
class BaseTransform:
    """reference transforms.py BaseTransform: keys-aware callable base. The
    functional core here applies `_apply_image` to array inputs."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, inputs):
        if isinstance(inputs, (list, tuple)):
            keys = list(self.keys) + ["__passthrough__"] * (
                len(inputs) - len(self.keys))   # extras pass through untouched
            return type(inputs)(
                self._apply_image(v) if k == "image" else v
                for k, v in zip(keys, inputs))
        return self._apply_image(inputs)


class Transpose(BaseTransform):
    """reference Transpose: HWC -> CHW (or a custom order)."""

    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = tuple(order)

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


def adjust_hue(img, hue_factor):
    """reference functional adjust_hue: shift hue by hue_factor in [-0.5, 0.5]
    via RGB->HSV->RGB (vectorized numpy)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3)
    a = arr if not chw else arr.transpose(1, 2, 0)
    maxv = 255.0 if a.dtype == np.uint8 else 1.0
    rgb = a.astype(np.float32) / maxv
    import colorsys  # noqa: F401 (documented algorithm; vectorized below)
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) / 6
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = out * maxv
    if arr.dtype == np.uint8:
        out = np.round(out)        # truncation would bias the roundtrip -1
    out = out.astype(arr.dtype)
    return out.transpose(2, 0, 1) if chw else out


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        u = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, u)


def _affine_matrix(angle, translate, scale, shear, center):
    import math as _m
    rot = _m.radians(angle)
    sx, sy = (_m.radians(s) for s in shear)
    cx, cy = center
    # torch convention: M = T(center) R S Sh T(-center) + translate
    a = _m.cos(rot - sy) / _m.cos(sy)
    b = -_m.cos(rot - sy) * _m.tan(sx) / _m.cos(sy) - _m.sin(rot)
    c = _m.sin(rot - sy) / _m.cos(sy)
    d = -_m.sin(rot - sy) * _m.tan(sx) / _m.cos(sy) + _m.cos(rot)
    mat = np.array([[a, b, 0.0], [c, d, 0.0]]) * scale
    mat[0, 2] = translate[0] + cx - mat[0, 0] * cx - mat[0, 1] * cy
    mat[1, 2] = translate[1] + cy - mat[1, 0] * cx - mat[1, 1] * cy
    return mat


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """reference functional affine: inverse-warp sampling with the affine
    matrix (nearest/bilinear)."""
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3)
    a = arr if not chw else arr.transpose(1, 2, 0)
    if a.ndim == 2:
        a = a[..., None]
    H, W = a.shape[:2]
    if isinstance(shear, (int, float)):
        shear = (float(shear), 0.0)
    ctr = center if center is not None else ((W - 1) / 2, (H - 1) / 2)
    M = _affine_matrix(angle, translate, scale, shear, ctr)
    Mi = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:H, 0:W]
    src = Mi @ np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)])
    sx, sy = src[0].reshape(H, W), src[1].reshape(H, W)
    out = _warp_sample(a, sx, sy, interpolation, fill)
    if arr.ndim == 2:
        out = out[..., 0]
    return out.transpose(2, 0, 1) if chw else out


def _warp_sample(a, sx, sy, interpolation, fill):
    """Inverse-warp gather shared by affine/perspective (HWC array in)."""
    H, W = a.shape[:2]
    if interpolation == "bilinear":
        x0, y0 = np.floor(sx), np.floor(sy)
        out = np.zeros_like(a, np.float32)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1 - np.abs(sx - xi)) * (1 - np.abs(sy - yi))
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            xi_c = np.clip(xi, 0, W - 1).astype(int)
            yi_c = np.clip(yi, 0, H - 1).astype(int)
            pix = np.where(ok[..., None], a[yi_c, xi_c].astype(np.float32),
                           float(fill))
            out = out + wgt[..., None] * pix
        return out.astype(a.dtype)
    xi = np.round(sx).astype(int)
    yi = np.round(sy).astype(int)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    return np.where(ok[..., None],
                    a[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)],
                    np.asarray(fill, a.dtype))


class RandomAffine(BaseTransform):
    """reference RandomAffine."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if isinstance(degrees, (int, float)) \
            else tuple(degrees)
        self.translate, self.scale_rng = translate, scale
        self.shear = shear
        self.interpolation, self.fill, self.center = interpolation, fill, center

    def _apply_image(self, img):
        arr = np.asarray(img)
        H, W = (arr.shape[-2:] if arr.shape[0] in (1, 3) and arr.ndim == 3
                else arr.shape[:2])
        angle = np.random.uniform(*self.degrees)
        tr = (0, 0)
        if self.translate:
            tr = (np.random.uniform(-self.translate[0], self.translate[0]) * W,
                  np.random.uniform(-self.translate[1], self.translate[1]) * H)
        sc = np.random.uniform(*self.scale_rng) if self.scale_rng else 1.0
        sh = (0.0, 0.0)
        if self.shear is not None:
            s = self.shear if isinstance(self.shear, (list, tuple)) \
                else (-self.shear, self.shear)
            sy = np.random.uniform(s[2], s[3]) if len(s) == 4 else 0.0
            sh = (np.random.uniform(s[0], s[1]), sy)
        return affine(img, angle, tr, sc, sh, self.interpolation, self.fill,
                      self.center)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """reference functional perspective: 4-point homography warp."""
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3)
    a = arr if not chw else arr.transpose(1, 2, 0)
    if a.ndim == 2:
        a = a[..., None]
    H, W = a.shape[:2]
    # solve homography endpoints -> startpoints (inverse warp)
    A, bvec = [], []
    for (ex, ey), (sx_, sy_) in zip(endpoints, startpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx_ * ex, -sx_ * ey]); bvec.append(sx_)
        A.append([0, 0, 0, ex, ey, 1, -sy_ * ex, -sy_ * ey]); bvec.append(sy_)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(bvec, np.float64))
    Hm = np.append(h, 1.0).reshape(3, 3)
    ys, xs = np.mgrid[0:H, 0:W]
    pts = Hm @ np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)])
    sx = (pts[0] / pts[2]).reshape(H, W)
    sy = (pts[1] / pts[2]).reshape(H, W)
    out = _warp_sample(a, sx, sy, interpolation, fill)
    if arr.ndim == 2:
        out = out[..., 0]
    return out.transpose(2, 0, 1) if chw else out


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.scale = prob, distortion_scale
        self.interpolation, self.fill = interpolation, fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = np.asarray(img)
        H, W = (arr.shape[-2:] if arr.shape[0] in (1, 3) and arr.ndim == 3
                else arr.shape[:2])
        d = self.scale
        dx = lambda: int(np.random.uniform(0, d * W / 2))
        dy = lambda: int(np.random.uniform(0, d * H / 2))
        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        end = [(dx(), dy()), (W - 1 - dx(), dy()),
               (W - 1 - dx(), H - 1 - dy()), (dx(), H - 1 - dy())]
        return perspective(img, start, end, self.interpolation, self.fill)


def _spatial_axes(arr):
    """(h_axis, w_axis) honoring the reference layout contract: np arrays
    are HWC (or HW), Tensors/CHW arrays are [..., H, W]."""
    if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and \
            arr.shape[0] not in (1, 3, 4):
        return 0, 1                                    # HWC
    if arr.ndim == 2:
        return 0, 1
    return arr.ndim - 2, arr.ndim - 1                  # CHW / batched CHW


def erase(img, i, j, h, w, v, inplace=False):
    """reference functional erase (Tensor: CHW; np.array: HWC)."""
    if isinstance(img, Tensor):
        out = img.clone() if not inplace else img
        out[..., i:i + h, j:j + w] = v
        return out
    arr = np.asarray(img)
    out = arr if inplace else arr.copy()
    ha, wa = _spatial_axes(out)
    sl = [slice(None)] * out.ndim
    sl[ha] = slice(i, i + h)
    sl[wa] = slice(j, j + w)
    out[tuple(sl)] = v
    return out


class RandomErasing(BaseTransform):
    """reference RandomErasing (CHW arrays/Tensors)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = np.asarray(img._data) if isinstance(img, Tensor) else np.asarray(img)
        if isinstance(img, Tensor):
            H, W = arr.shape[-2:]
        else:
            ha, wa = _spatial_axes(arr)
            H, W = arr.shape[ha], arr.shape[wa]
        area = H * W
        for _ in range(10):
            a = np.random.uniform(*self.scale) * area
            r = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                         np.log(self.ratio[1])))
            h, w = int(round(np.sqrt(a * r))), int(round(np.sqrt(a / r)))
            if h < H and w < W:
                i = np.random.randint(0, H - h)
                j = np.random.randint(0, W - w)
                return erase(img, i, j, h, w, self.value, self.inplace)
        return img
