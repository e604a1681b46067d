"""Roofline attribution for per-contraction spans (paper §II-B), with the
ceilings of the card the work runs on.

Per contraction the attribution is the paper's arithmetic-intensity
analysis in record form, counted exactly as the JAX package counts it:

* ``flops`` — ``2·∏ dims`` over every distinct mode
  (:func:`repro_torch.core.planner.contraction_flops`);
* ``bytes`` — operand + output element counts × itemsize (the minimum
  traffic of a transpose-free evaluation: each input read once, the
  output written once);
* ``intensity`` — flops / bytes;
* ``roofline_bound_us`` — ``max(flops / peak, bytes / HBM rate)`` for the
  operands' type on the card: the least time the card could take.  Only a
  contraction on a CUDA device has one; on the CPU the key is absent, so no
  fraction is ever derived from it.

The ceilings live in :data:`DEVICE_PEAKS`, keyed on
``torch.cuda.get_device_name()`` and, for the arithmetic peak, on the
operands' type.  An unknown card raises :class:`KeyError` naming the
table: a bound never borrows another card's numbers.

A span carrying ``roofline_bound_us`` gains ``roofline_fraction`` (bound ÷
measured duration, see :class:`repro_torch.obs.trace.Tracer`): ~1.0 means
roofline-saturating, ≪ 1 means overhead or a wrong strategy.  On the card
``contract`` spans divide by their device time (a CUDA event pair around
the body), never by the host's enqueue time.
"""

from __future__ import annotations

import torch

__all__ = [
    "DEVICE_PEAKS",
    "device_peaks",
    "roofline_bound",
    "roofline_bound_us",
    "arithmetic_intensity",
    "contraction_record",
]

#: per card: HBM rate and interconnect rate (bytes/s) and the dense peak
#: arithmetic rate (flop/s) for each operand type.  H100 SXM at 700 W,
#: NVIDIA's H100 data sheet: HBM3 3.35 TB/s, NVLink 900 GB/s, bf16/fp16
#: tensor cores 989 TFLOP/s dense, float32 67 TFLOP/s and float64 34
#: TFLOP/s outside the tensor cores.  float32 takes the FMA peak because
#: the port never runs float32 products on TF32.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "link_bytes_per_s": 900e9,
        "flops_per_s": {"float64": 34e12, "float32": 67e12,
                        "bfloat16": 989e12, "float16": 989e12},
    },
}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def device_peaks(name: str) -> dict:
    """The :data:`DEVICE_PEAKS` entry of the card called ``name`` (as
    ``torch.cuda.get_device_name()`` gives it); raises ``KeyError`` for a
    card the table does not hold."""
    try:
        return DEVICE_PEAKS[name]
    except KeyError:
        raise KeyError(
            f"no roofline ceilings for {name!r}: repro_torch.obs.roofline."
            f"DEVICE_PEAKS holds {sorted(DEVICE_PEAKS)}") from None


def roofline_bound(flops: float, bytes_: float, dtype, name: str
                   ) -> tuple[float, str]:
    """Least µs for ``flops`` of type ``dtype`` and ``bytes_`` moved on the
    card called ``name``, and which ceiling sets it (``"bytes"`` or
    ``"operations"``)."""
    peaks = device_peaks(name)
    rates = peaks["flops_per_s"]
    dt = _dtype_name(dtype)
    if dt not in rates:
        raise KeyError(f"no {dt} peak for {name!r} in repro_torch.obs.roofline."
                       f"DEVICE_PEAKS (it holds {sorted(rates)})")
    t_bytes, t_ops = bytes_ / peaks["hbm_bytes_per_s"], flops / rates[dt]
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def roofline_bound_us(flops: float, bytes_: float, dtype, name: str) -> float:
    """Minimum achievable µs under the card's compute and memory ceilings."""
    return roofline_bound(flops, bytes_, dtype, name)[0]


def arithmetic_intensity(flops: float, bytes_: float) -> float:
    """Flops per byte moved (0.0 for a zero-byte degenerate case)."""
    return flops / bytes_ if bytes_ else 0.0


def contraction_record(cs, dims: dict, dtype, device=None) -> dict:
    """The attribution attributes of one pairwise contraction.

    ``cs`` is a :class:`repro_torch.core.notation.ContractionSpec`, ``dims``
    the mode→size map, ``dtype`` the operands' result type (a torch dtype
    or its name).  ``roofline_bound_us`` is present only for a CUDA
    ``device`` (the card's ceilings); pure arithmetic otherwise.
    """
    from repro_torch.core.planner import contraction_flops, modes_size

    dt = _dtype_name(dtype)
    itemsize = getattr(torch, dt).itemsize
    flops = contraction_flops(cs, dims)
    nbytes = itemsize * (
        modes_size(cs.a_modes, dims)
        + modes_size(cs.b_modes, dims)
        + modes_size(cs.c_modes, dims)
    )
    rec = {
        "spec": cs.spec_str(),
        "dtype": dt,
        "flops": int(flops),
        "bytes": int(nbytes),
        "intensity": arithmetic_intensity(flops, nbytes),
    }
    if device is not None and torch.device(device).type == "cuda":
        rec["roofline_bound_us"] = roofline_bound_us(
            flops, nbytes, dt, torch.cuda.get_device_name(device))
    return rec
