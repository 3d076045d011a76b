"""Dense distance-decay background-error covariance: CUDA kernel, plain version.

Counterpart of :mod:`oisat_tpu.ops.kernels.covariance`:

    B[i, j] = sigma_i sigma_j exp(-d_ij^2 / (2 L^2)),   d^2 = (2R)^2 clip(hav, 0, 1)

with ``hav`` the haversine of the pair and ``R`` the Earth radius -- the
chordal distance, whose Gaussian is positive definite on the sphere and
needs no asin.  Everything is float32, as in the JAX kernel.

* :func:`build_covariance_kernel` launches ``csrc/covariance.cu`` (CUDA
  tensors only) and counts its launches in ``build_covariance_kernel.launches``.
* :func:`build_covariance_plain` is the same float32 formula as torch
  broadcasts (the CPU tests use it; ``chip_smoke.py`` compares the kernel
  with it on the card).
* :func:`build_covariance` takes degrees and picks by the tensors' device:
  the plain version on the CPU, the kernel on CUDA, never a fallback; no
  caller picks the engine.  There is no ``N % tile`` requirement and no
  padding.
* :func:`build_covariance_reference` is the NumPy float64 golden.

The float64 dense scan's ``C = D^-1 B D^-1`` comes from the same source:

    C[i, j] = s_i s_j exp(max(kappa (clip(u_i . u_j, -1, 1) - 1), -60))

for unit vectors ``u`` (N, 3), ``s = sigma_b / sigma_o`` and
``kappa = (R / L)^2``.  :func:`whitened_correlation_kernel` launches it
(float64, CUDA tensors only, launches counted),
:func:`correlation_plain` is the same formula as torch operations (without
``s``, the correlation G that the exact branch builds in place), and
:func:`whitened_correlation` picks by the tensors' device as
:func:`build_covariance` does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.ops.kernels._build import load_library

__all__ = ["EARTH_RADIUS_KM", "build_covariance", "build_covariance_kernel",
           "build_covariance_plain", "build_covariance_reference", "correlation_plain",
           "radians_f32", "whitened_correlation", "whitened_correlation_kernel"]

EARTH_RADIUS_KM = 6371.0
_SOURCE = "covariance"
# float32(pi / 180): jnp.deg2rad multiplies a float32 array by this constant
_DEG2RAD_F32 = float(np.float32(np.pi / 180.0))


def _constants(length_scale_km: float):
    """(c_d2, two_l2) as the float32 values the JAX kernel folds its Python
    constants (4 R^2) and (2 L^2) into."""
    return (float(np.float32(4.0 * EARTH_RADIUS_KM * EARTH_RADIUS_KM)),
            float(np.float32(2.0 * length_scale_km * length_scale_km)))


def _f32_vector(x, device) -> torch.Tensor:
    """``x`` (array or tensor of N values) as a contiguous 1-D float32 tensor
    on ``device``."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device).reshape(-1).to(torch.float32).contiguous()


def radians_f32(deg, device) -> torch.Tensor:
    """Degrees -> float32 radians on ``device`` in the JAX order: cast to
    float32 first, then multiply by float32(pi/180)."""
    return (_f32_vector(deg, device) * _DEG2RAD_F32).contiguous()


def build_covariance_plain(lat: torch.Tensor, lon: torch.Tensor, sigma: torch.Tensor,
                           length_scale_km: float) -> torch.Tensor:
    """(N, N) float32 B from float32 radians and sigma, as torch broadcasts in
    the JAX kernel's order of operations."""
    c_d2, two_l2 = _constants(length_scale_km)
    sdlat = torch.sin(0.5 * (lat[:, None] - lat[None, :]))
    sdlon = torch.sin(0.5 * (lon[:, None] - lon[None, :]))
    cl = torch.cos(lat)
    hav = sdlat * sdlat + cl[:, None] * cl[None, :] * sdlon * sdlon
    d2 = c_d2 * torch.clamp(hav, 0.0, 1.0)
    # divide by a tensor, not a Python float: PyTorch turns division by a
    # scalar into a multiply by its reciprocal, which rounds differently
    # from the true division of the kernel (and of the JAX kernel)
    decay = torch.exp(-d2 / torch.tensor(two_l2, dtype=d2.dtype, device=d2.device))
    return sigma[:, None] * sigma[None, :] * decay


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p: ctypes would cut them to 32-bit ints)."""
    lib = load_library(_SOURCE)
    lib.covariance_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.covariance_f32.restype = ctypes.c_int
    lib.correlation_f64.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
    lib.correlation_f64.restype = ctypes.c_int
    lib.covariance_max_n.argtypes = []
    lib.covariance_max_n.restype = ctypes.c_longlong
    lib.covariance_error_string.argtypes = [ctypes.c_int]
    lib.covariance_error_string.restype = ctypes.c_char_p
    return lib


def build_covariance_kernel(lat: torch.Tensor, lon: torch.Tensor, sigma: torch.Tensor,
                            length_scale_km: float) -> torch.Tensor:
    """(N, N) float32 B from the CUDA kernel.

    ``lat``, ``lon`` (radians) and ``sigma``: contiguous 1-D float32 tensors
    of one length on one CUDA device.  Raises on anything else; launches on
    the current stream without synchronising."""
    for name, t in (("lat", lat), ("lon", lon), ("sigma", sigma)):
        if t.device.type != "cuda":
            raise ValueError(f"covariance kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"covariance kernel takes float32, got {name} {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"covariance kernel needs a contiguous 1-D {name}")
    if not (lat.device == lon.device == sigma.device):
        raise ValueError("lat, lon and sigma must share one device")
    n = lat.numel()
    if lon.numel() != n or sigma.numel() != n:
        raise ValueError(f"lat, lon, sigma lengths differ: {n}, {lon.numel()}, {sigma.numel()}")
    out = torch.empty((n, n), dtype=torch.float32, device=lat.device)
    if n == 0:
        return out  # nothing to launch
    lib = _library()
    if n > lib.covariance_max_n():
        raise ValueError(f"covariance kernel takes at most {lib.covariance_max_n()} cells, got {n}")
    c_d2, two_l2 = _constants(length_scale_km)
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream(lat.device).cuda_stream
        rc = lib.covariance_f32(lat.data_ptr(), lon.data_ptr(), sigma.data_ptr(), n,
                                c_d2, two_l2, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.covariance_error_string(rc).decode()
        raise RuntimeError(f"covariance kernel launch failed: CUDA error {rc} ({msg})")
    build_covariance_kernel.launches += 1
    return out


build_covariance_kernel.launches = 0


def correlation_plain(u3: torch.Tensor, kappa: float, s: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The N x N correlation ``exp(kappa (u.u - 1))`` of the unit vectors
    ``u3`` (N, 3), in their dtype and on their device: one new tensor, every
    step after the product in place (the argument clipped at -60, as on the
    host); with ``s`` (N,) scaled in place to ``diag(s) G diag(s)``."""
    g = u3 @ u3.T
    g.clamp_(-1.0, 1.0).sub_(1.0).mul_(kappa).clamp_(min=-60.0).exp_()
    return g if s is None else g.mul_(s[:, None]).mul_(s[None, :])


def whitened_correlation_kernel(u3: torch.Tensor, s: torch.Tensor, kappa: float
                                ) -> torch.Tensor:
    """(N, N) float64 ``diag(s) G diag(s)`` from the CUDA kernel, bitwise
    symmetric.

    ``u3``: contiguous (N, 3) float64 unit vectors and ``s``: contiguous
    (N,) float64, on one CUDA device.  Raises on anything else; launches on
    the current stream without synchronising."""
    if u3.device.type != "cuda" or s.device != u3.device:
        raise ValueError(f"the correlation kernel needs u3 and s on one CUDA device, got "
                         f"{u3.device} and {s.device}")
    if u3.dtype != torch.float64 or s.dtype != torch.float64:
        raise TypeError(f"the correlation kernel takes float64, got {u3.dtype} and {s.dtype}")
    n = s.numel()
    if u3.shape != (n, 3) or s.dim() != 1 or not (u3.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"the correlation kernel needs contiguous (N, 3) and (N,) tensors, "
                         f"got {tuple(u3.shape)} and {tuple(s.shape)}")
    out = torch.empty((n, n), dtype=torch.float64, device=u3.device)
    if n == 0:
        return out  # nothing to launch
    lib = _library()
    if n > lib.covariance_max_n():
        raise ValueError(f"the correlation kernel takes at most {lib.covariance_max_n()} "
                         f"cells, got {n}")
    with torch.cuda.device(u3.device):
        stream = torch.cuda.current_stream(u3.device).cuda_stream
        rc = lib.correlation_f64(u3.data_ptr(), s.data_ptr(), n, float(kappa), out.data_ptr(),
                                 stream)
    if rc != 0:
        msg = lib.covariance_error_string(rc).decode()
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc} ({msg})")
    whitened_correlation_kernel.launches += 1
    return out


whitened_correlation_kernel.launches = 0


def whitened_correlation(u3: torch.Tensor, s: torch.Tensor, kappa: float) -> torch.Tensor:
    """``diag(s) G diag(s)`` (N, N) in ``u3``'s dtype: the kernel for CUDA
    tensors, the plain version for the CPU, with no fallback."""
    if u3.device.type == "cpu":
        return correlation_plain(u3, kappa, s)
    return whitened_correlation_kernel(u3, s, kappa)


def build_covariance(lat_deg, lon_deg, sigma, length_scale_km: float, *,
                     device) -> torch.Tensor:
    """B (N, N) float32 on ``device`` from degree coordinates and the
    per-cell background std (arrays or tensors of N values): the plain
    version for the CPU, the kernel for CUDA, with no fallback."""
    dev = resolve_device(device)
    engine = build_covariance_plain if dev.type == "cpu" else build_covariance_kernel
    return engine(radians_f32(lat_deg, dev), radians_f32(lon_deg, dev),
                  _f32_vector(sigma, dev), float(length_scale_km))


def build_covariance_reference(lat_deg, lon_deg, sigma, length_scale_km):
    """NumPy float64 reference (``oisat_tpu.ops.kernels.covariance.
    build_covariance_reference``)."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    sdlat = np.sin(0.5 * (lat[:, None] - lat[None, :]))
    sdlon = np.sin(0.5 * (lon[:, None] - lon[None, :]))
    a = sdlat**2 + np.cos(lat[:, None]) * np.cos(lat[None, :]) * sdlon**2
    d2 = (2.0 * EARTH_RADIUS_KM) ** 2 * np.clip(a, 0, 1)
    sig = np.asarray(sigma, np.float64)
    return sig[:, None] * sig[None, :] * np.exp(-d2 / (2 * length_scale_km**2))
