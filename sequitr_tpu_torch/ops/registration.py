"""Drift correction: FFT phase-correlation stack registration.

Port of ``sequitr_tpu.ops.registration`` on ``torch.fft`` (cuFFT on the
card). The estimator is the standard phase correlation (Kuglin & Hines
1975) with parabolic sub-pixel refinement; every device function runs on
its inputs' device and holds no Python control flow that depends on the
data, so nothing waits for the card except where a caller fetches a
result (``float(resp)``, ``.cpu()``) or integer mode rolls (below).

* A streaming step (``register_step``) costs two forward FFTs per frame
  (the windowed spectrum for correlation, the raw one for the resample
  and the refinement passes), an inverse FFT for the correlation surface
  and one for the resample; each extra ``refine`` pass costs three more.
  Callers that do not need the resample pass ``resample=False``.
* Batched forms have a leading batch dim: ``register_batch`` (first-frame
  mode) and the mosaic's strip correlator run every frame or pair of a
  batch in the same FFT calls.
* The peak search is ``argmax`` (the FIRST maximum of the flattened
  surface, as JAX's) plus gathers with wrapped neighbour indices; the
  sub-pixel parabola is branchless (``torch.where``).
* The Hann window biases the estimate in proportion to the shift;
  ``refine`` re-correlates after shifting the moving frame back by the
  running estimate, and the bias collapses geometrically.
* Estimation runs in float32/complex64, in the JAX package's order of
  operations: the phase ramp is ``fftfreq(n)`` (f32) times the shift,
  summed over axes, times f32(-2 pi), then cos + i sin (complex64); the
  whitening regularizer ``1e-4 * mean(|r|) + 1e-30`` stays in f32; the
  response is over the POPULATION std of the surface.
* Integer mode (``subpixel=False``) rolls by ``round(shift)`` (half to
  even, as ``jnp.round``). ``torch.roll`` takes Python ints, so an integer
  resample costs one host sync (the shifts of a whole batch in one).

Conventions (the JAX package's): ``phase_correlate(ref, mov)`` returns the
shift with ``apply_shift(mov, shift) ≈ ref``, one component per axis
((dy, dx) for frames, (dz, dy, dx) for volumes), canonical in
(-N/2, N/2]. ``apply_shift`` resamples by the Fourier shift theorem:
exact for band-limited content, WRAPPING at the borders.
``unwrap_trajectory`` and ``common_crop`` are host numpy, copied.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "hann_window",
    "hann2d",
    "phase_correlate",
    "apply_shift",
    "register_step",
    "register_batch",
    "unwrap_trajectory",
    "common_crop",
]

_NEG_TWO_PI = float(np.float32(-2.0 * math.pi))  # the complex64 constant JAX's ramp uses


def _fft_dims(nd: int) -> Tuple[int, ...]:
    return tuple(range(-nd, 0))


# windows and frequency vectors by (shape, device): a streamed stack builds
# each once, not once a frame (callers never write into them)
_CONSTANTS: dict = {}


def _constant(key, build) -> torch.Tensor:
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = build()
    return hit


def hann_window(shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """Separable N-D Hann window (float32): damps spectral leakage from the
    non-periodic frame/volume borders before the correlation FFT."""
    shape = tuple(int(n) for n in shape)
    dev = torch.device("cpu" if device is None else device)
    return _constant(("hann", shape, dev), lambda: _hann(shape, dev))


def hann2d(shape: Tuple[int, int], device=None) -> torch.Tensor:
    """2D alias of ``hann_window`` (the original public name)."""
    return hann_window(shape, device)


def _hann(shape: Tuple[int, ...], device) -> torch.Tensor:
    out = None
    nd = len(shape)
    for ax, n in enumerate(shape):
        k = torch.arange(n, dtype=torch.float32, device=device)
        w = 0.5 - 0.5 * torch.cos(k * (2.0 * math.pi) / n)
        w = w.reshape([-1 if i == ax else 1 for i in range(nd)])
        out = w if out is None else out * w
    return out


def _window(shape, window: bool, device) -> torch.Tensor:
    if window:
        return hann_window(shape, device)
    return torch.ones(shape, dtype=torch.float32, device=device)


def _wrap_to_signed(p: torch.Tensor, n: int) -> torch.Tensor:
    """Map a peak index in [0, n) to the signed shift in (-n/2, n/2]."""
    return torch.where(p > n // 2, p - n, p)


def _parabolic_offset(cm: torch.Tensor, c0: torch.Tensor, cp: torch.Tensor):
    """3-point parabola vertex offset in [-0.5, 0.5] (branchless); a flat
    surface (denominator ~ 0) gives offset 0 instead of NaN."""
    denom = cm - 2.0 * c0 + cp
    off = torch.where(
        denom.abs() > 1e-12, 0.5 * (cm - cp) / denom, torch.zeros_like(denom)
    )
    return off.clamp(-0.5, 0.5)


def _correlation_peak(surface: torch.Tensor, subpixel: bool, nd: int):
    """Peak of the correlation surfaces (``(..., *dims)``, the last ``nd``
    dims spatial) as signed shift vectors ``(..., nd)``, plus the
    peak-to-sidelobe responses ``(...)``: peak minus surface mean, in
    population standard deviations."""
    dims = tuple(surface.shape[-nd:])
    lead = tuple(surface.shape[:-nd])
    flat = surface.reshape(lead + (-1,))
    am = flat.argmax(dim=-1)  # the first maximum

    def at(flat_idx):
        return flat.gather(-1, flat_idx.unsqueeze(-1)).squeeze(-1)

    peak = at(am)
    idx = torch.unravel_index(am, dims)
    comps = []
    stride = 1
    strides = []
    for n in reversed(dims):
        strides.insert(0, stride)
        stride *= n
    for ax, n in enumerate(dims):
        if subpixel:
            base = am - idx[ax] * strides[ax]
            lo = at(base + ((idx[ax] - 1) % n) * strides[ax])
            hi = at(base + ((idx[ax] + 1) % n) * strides[ax])
            off = _parabolic_offset(lo, peak, hi)
        else:
            off = torch.zeros_like(peak)
        comps.append(_wrap_to_signed(idx[ax], n).to(torch.float32) + off)
    std = flat.std(dim=-1, correction=0)
    resp = (peak - flat.mean(dim=-1)) / torch.clamp(std, min=1e-30)
    return torch.stack(comps, dim=-1), resp


def _cross_power_surface(ref_fft: torch.Tensor, mov_fft: torch.Tensor, nd: int):
    """Inverse FFT of the normalized cross-power spectrum. The regularizer
    is RELATIVE to the spectrum's scale, so frequencies carrying ~zero
    energy do not contribute their garbage phases at full weight."""
    dims = _fft_dims(nd)
    r = ref_fft * mov_fft.conj()
    mag = r.abs()
    denom = mag + 1e-4 * mag.mean(dim=dims, keepdim=True) + 1e-30
    r = torch.complex(r.real / denom, r.imag / denom)
    return torch.fft.ifftn(r, dim=dims).real


def _fftfreq(n: int, device) -> torch.Tensor:
    """``jnp.fft.fftfreq(n)``: f32 integers divided by f32 ``n``."""
    dev = torch.device(device)
    return _constant(("freq", int(n), dev), lambda: _freq(int(n), dev))


def _freq(n: int, device) -> torch.Tensor:
    k = torch.cat([
        torch.arange(0, (n - 1) // 2 + 1, device=device),
        torch.arange(-(n // 2), 0, device=device),
    ]).to(torch.float32)
    return k / n


def _shift_ramp(shape: Tuple[int, ...], shift: torch.Tensor) -> torch.Tensor:
    """Phase ramps ``(..., *shape)`` implementing out(x) = in(x - shift) in
    the frequency domain, for shifts ``(..., nd)``."""
    nd = len(shape)
    lead = tuple(shift.shape[:-1])
    phase = None
    for ax, n in enumerate(shape):
        f = _fftfreq(n, shift.device).reshape([-1 if i == ax else 1 for i in range(nd)])
        term = f * shift[..., ax].reshape(lead + (1,) * nd)
        phase = term if phase is None else phase + term
    theta = phase * _NEG_TWO_PI
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _refined_peak(ref_fft_win, mov_fft_win, mov_fft_raw, win, subpixel: bool, refine: int, nd: int):
    """Correlation peak with window-debiasing refinement passes: each pass
    after the first translates the moving frame back by the running
    estimate (a phase ramp on its RAW spectrum), re-windows it and
    correlates the residual. Unrolled: ``refine`` is a Python int."""
    dims = _fft_dims(nd)
    shape = tuple(mov_fft_raw.shape[-nd:])
    surface = _cross_power_surface(ref_fft_win, mov_fft_win, nd)
    total, resp = _correlation_peak(surface, subpixel, nd)
    for _ in range(max(0, refine - 1)):
        shifted = torch.fft.ifftn(mov_fft_raw * _shift_ramp(shape, total), dim=dims).real
        surface = _cross_power_surface(ref_fft_win, torch.fft.fftn(shifted * win, dim=dims), nd)
        step, resp = _correlation_peak(surface, subpixel, nd)
        total = total + step
    return total, resp


def _correlate(ref, mov, nd: int, subpixel: bool, window: bool, refine: int):
    """``phase_correlate`` over leading batch dims (the last ``nd`` dims
    spatial): one FFT call per stage for the whole batch."""
    ref = ref.to(torch.float32)
    mov = mov.to(torch.float32)
    dims = _fft_dims(nd)
    win = _window(tuple(ref.shape[-nd:]), window, ref.device)
    # mov(x) = ref(x - d) => the surface peaks at x = -d, which is the
    # aligning shift itself
    return _refined_peak(
        torch.fft.fftn(ref * win, dim=dims),
        torch.fft.fftn(mov * win, dim=dims),
        torch.fft.fftn(mov, dim=dims),
        win, subpixel, refine, nd,
    )


def phase_correlate(
    ref: torch.Tensor,
    mov: torch.Tensor,
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation of ``mov`` relative to ``ref`` by phase correlation.

    N-dimensional: (H, W) frames give a 2-vector, (Z, H, W) volumes a
    3-vector. Returns ``(shift, response)`` on the inputs' device:
    ``shift`` float32 with ``apply_shift(mov, shift) ≈ ref``;
    ``response`` the correlation peak-to-sidelobe ratio (low values flag
    unreliable estimates). ``refine`` is the number of correlation passes.
    """
    return _correlate(ref, mov, ref.dim(), subpixel, window, refine)


def apply_shift(frame: torch.Tensor, shift) -> torch.Tensor:
    """Translate ``frame`` by a (possibly sub-pixel) per-axis shift vector
    ((dy, dx) for frames, (dz, dy, dx) for volumes): exact sinc
    interpolation by the Fourier shift theorem, wrapping at the borders.

    ``shift`` of shape ``(..., nd)`` shifts a batch ``(..., *dims)`` item by
    item. Output is float32 on ``frame``'s device.
    """
    shift = torch.as_tensor(shift, dtype=torch.float32, device=frame.device)
    nd = shift.shape[-1]
    dims = _fft_dims(nd)
    f = torch.fft.fftn(frame.to(torch.float32), dim=dims)
    return torch.fft.ifftn(f * _shift_ramp(tuple(frame.shape[-nd:]), shift), dim=dims).real


def _roll(f32: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Integer-mode resample: roll by ``round(shift)`` (one host sync)."""
    r = torch.round(shift).to(torch.int64).tolist()
    return torch.roll(f32, tuple(r), dims=tuple(range(f32.dim())))


def register_step(
    anchor_fft: torch.Tensor,
    frame: torch.Tensor,
    cum_shift: torch.Tensor,
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
    resample: bool = True,
):
    """One streaming-registration step.

    Correlates ``frame`` against the anchor spectrum (previous frame for
    drift mode, first frame for reference mode) with ``refine``
    window-debiasing passes, accumulates the trajectory, and resamples the
    frame by the cumulative shift.

    Args:
      anchor_fft: windowed FFT of the anchor frame (from a previous step).
      frame: (H, W) new frame, or (Z, H, W) for volumetric registration,
        any dtype (cast to f32 on its device).
      cum_shift: (ndim,) float32 cumulative shift of the ANCHOR frame.

    Returns ``(frame_fft_win, new_cum, corrected, step_shift, response)``:
    ``new_cum = cum_shift + step_shift`` moves this frame onto the stack's
    first frame and ``corrected = apply_shift(frame, new_cum)`` (integer
    mode: the f32 frame rolled by ``round(new_cum)``, values exact);
    ``resample=False`` returns ``corrected=None`` and skips its FFT.
    """
    nd = frame.dim()
    dims = _fft_dims(nd)
    f32 = frame.to(torch.float32)
    win = _window(tuple(frame.shape), window, frame.device)
    frame_fft_win = torch.fft.fftn(f32 * win, dim=dims)
    raw_fft = torch.fft.fftn(f32, dim=dims)
    step_shift, resp = _refined_peak(anchor_fft, frame_fft_win, raw_fft, win, subpixel, refine, nd)
    new_cum = cum_shift + step_shift
    if not resample:
        corrected = None
    elif subpixel:
        corrected = torch.fft.ifftn(raw_fft * _shift_ramp(tuple(frame.shape), new_cum), dim=dims).real
    else:
        corrected = _roll(f32, new_cum)
    return frame_fft_win, new_cum, corrected, step_shift, resp


def register_batch(
    ref: torch.Tensor,
    frames: torch.Tensor,
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
    resample: bool = True,
):
    """First-frame-mode registration of a whole batch at once.

    Every frame correlates against the SAME reference, so the batch
    ``frames`` (B, H, W) (or (B, Z, H, W)) runs through each FFT stage in
    one call. Returns ``(shifts, responses, corrected)`` with leading dim
    B; ``resample=False`` returns zeros (B,) in the corrected slot (the
    JAX package's placeholder) and skips the resample.
    """
    nd = ref.dim()
    dims = _fft_dims(nd)
    ref = ref.to(torch.float32)
    f32 = frames.to(torch.float32)
    win = _window(tuple(ref.shape), window, ref.device)
    raw = torch.fft.fftn(f32, dim=dims)
    shifts, resps = _refined_peak(
        torch.fft.fftn(ref * win, dim=dims), torch.fft.fftn(f32 * win, dim=dims),
        raw, win, subpixel, refine, nd,
    )
    if not resample:
        corrected = torch.zeros(f32.shape[0], dtype=torch.float32, device=f32.device)
    elif subpixel:
        corrected = torch.fft.ifftn(raw * _shift_ramp(tuple(ref.shape), shifts), dim=dims).real
    else:
        rs = torch.round(shifts).to(torch.int64).tolist()
        corrected = torch.stack([
            torch.roll(f, tuple(r), dims=tuple(range(nd))) for f, r in zip(f32, rs)
        ])
    return shifts, resps, corrected


def unwrap_trajectory(shifts: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Resolve the mod-N ambiguity of a per-frame shift trajectory.

    Each estimate is canonical in (-N/2, N/2]; when the true cumulative
    drift crosses that boundary (first-frame mode on a long drift), the
    reported value jumps by ~N between consecutive frames. Drift is
    continuous, so the physical trajectory is the one whose successive
    differences are minimal — exactly 1D phase unwrapping with period N
    per axis. No-op for trajectories that never wrap (previous-mode
    integration produces those by construction). Host-side: runs once
    per stack on a (T, ndim) array.
    """
    shifts = np.asarray(shifts, np.float64)
    out = shifts.copy()
    for ax, n in enumerate(shape):
        d = np.diff(shifts[:, ax])
        corr = np.cumsum(np.round(d / n)) * n
        out[1:, ax] = shifts[1:, ax] - corr
    return out


def common_crop(shifts: np.ndarray, shape: Tuple[int, ...]):
    """Per-axis slices of the field of view every registered frame (or
    volume) actually covers.

    ``shifts``: (T, ndim) cumulative per-frame shifts as returned by the
    registration loop, UNWRAPPED (`unwrap_trajectory`) — a mod-N wrapped
    trajectory would select exactly the stale wrapped region instead of
    the valid one. A frame shifted down by +d only has valid content
    for rows >= d (the wrapped rows at the top are stale); the common
    region trims the max positive shift off the leading edge and the max
    negative shift off the trailing edge of each axis.
    """
    shifts = np.asarray(shifts, np.float64)
    # eps absorbs estimator noise: a 1e-6 px "shift" on the reference
    # frame must not ceil into discarding a whole valid row
    eps = 1e-3
    out = []
    for ax, n in enumerate(shape):
        lo = int(np.ceil(max(0.0, shifts[:, ax].max()) - eps))
        hi = n + int(np.floor(min(0.0, shifts[:, ax].min()) + eps))
        if lo >= hi:
            raise ValueError(
                f"drift exceeds the frame: shifts span "
                f"{shifts.min(0)}..{shifts.max(0)} for shape {shape}"
            )
        out.append(slice(lo, hi))
    return tuple(out)
