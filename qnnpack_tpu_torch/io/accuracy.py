"""Accuracy-parity metrics for imported real-weight models - a numpy copy
of qnnpack_tpu/io/accuracy.py, kept here so that the port depends on
nothing of the JAX package.

QNNPACK's operator tests accept outputs within 0.9 quantum of an int32
reference (test/convolution-operator-tester.h:461-464); at model level the
same contract becomes element agreement within one quantum plus top-1
agreement between our execution and the source framework's interpreter.
"""

from __future__ import annotations

import numpy as np


def element_agreement(a_u8, b_u8, tolerance: int = 0) -> float:
    """Fraction of elements with |a - b| <= tolerance quanta."""
    a = np.asarray(a_u8).astype(np.int32)
    b = np.asarray(b_u8).astype(np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float((np.abs(a - b) <= tolerance).mean())


def top1_agreement(logits_a, logits_b) -> float:
    """Fraction of rows whose argmax class matches."""
    a = np.asarray(logits_a)
    b = np.asarray(logits_b)
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def top1_accuracy(logits, labels) -> float:
    """Top-1 accuracy of logits against integer labels."""
    return float((np.asarray(logits).argmax(-1) ==
                  np.asarray(labels).ravel()).mean())


def margin_stats(logits_u8) -> dict:
    """Top-1-vs-runner-up margin distribution, in output quanta.

    A *graded* health metric for saturated top-1 comparisons: a numerical
    regression shrinks margins (and shows up here) long before any argmax
    flips.  Reported as min / p10 / median over rows."""
    a = np.asarray(logits_u8).astype(np.int32)
    if a.shape[-1] < 2:
        raise ValueError(
            f"margin_stats needs >= 2 channels, got {a.shape[-1]} "
            "(a top-1 margin is undefined for single-class logits)")
    part = np.partition(a, a.shape[-1] - 2, axis=-1)
    margins = part[..., -1] - part[..., -2]
    return {"min": int(margins.min()),
            "p10": float(np.percentile(margins, 10)),
            "median": float(np.median(margins))}


def diff_stats(a_u8, b_u8) -> dict:
    """Graded output-difference metrics between two implementations:
    exact-match rate, mean |diff| in quanta, and max |diff| - all of which
    move before top-1 agreement does."""
    a = np.asarray(a_u8).astype(np.int32)
    b = np.asarray(b_u8).astype(np.int32)
    d = np.abs(a - b)
    return {"exact_pct": round(100.0 * float((d == 0).mean()), 3),
            "mean_quanta": round(float(d.mean()), 5),
            "max_quanta": int(d.max())}


def synth_images(n: int, size: int = 224, seed: int = 17) -> np.ndarray:
    """Deterministic structured evaluation images in [-1, 1], float32.

    Pure-numpy bilinear upsampling of low-resolution noise plus mild
    high-frequency detail - smooth, image-like statistics (unlike iid
    noise, whose activations are atypically narrow).  Used as the fixed
    input set for top-1 evaluation (ACCURACY.json): the repository bundles
    no labeled set, so labels are the float model's argmax on these images
    and both quantized implementations (ours and the TFLite interpreter)
    are scored against them side by side - measuring exactly the
    quantization-induced top-1 loss, which is the BASELINE.md "top-1 delta"
    contract.  The same seed gives the same images as the JAX package's.
    """
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (n, 28, 28, 3)).astype(np.float32)

    # Bilinear 28 -> size, fixed half-pixel convention.
    src = (np.arange(size, dtype=np.float64) + 0.5) * 28.0 / size - 0.5
    lo = np.clip(np.floor(src).astype(np.int64), 0, 27)
    hi = np.clip(lo + 1, 0, 27)
    frac = (src - lo).astype(np.float32)

    up = base[:, lo, :, :] * (1 - frac)[None, :, None, None] \
        + base[:, hi, :, :] * frac[None, :, None, None]
    up = up[:, :, lo, :] * (1 - frac)[None, None, :, None] \
        + up[:, :, hi, :] * frac[None, None, :, None]

    detail = rng.uniform(-0.12, 0.12, up.shape).astype(np.float32)
    return np.clip(up + detail, -1.0, 1.0)


def quantize_input(x_float: np.ndarray, scale: float,
                   zero_point_i8: int) -> np.ndarray:
    """Float [-1, 1] images -> int8 per the model's input quantization."""
    q = np.round(x_float / scale) + zero_point_i8
    return np.clip(q, -128, 127).astype(np.int8)
