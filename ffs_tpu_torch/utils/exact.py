"""Small-vector arithmetic that rounds as NumPy and the JAX package do.

The device paths must match host results bit for bit (bounding boxes,
ray predictions, profile corners), so their 3-vector products and norms
are explicit index-order sums: ``@`` on float64 goes through a BLAS with
FMA and ``sum`` reduces in its own order.  Divisions involving a Python
number go through :func:`quotient`, which rounds once.
"""

from __future__ import annotations

import torch


def sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3 in index order, as NumPy reduces it."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def dot3(v: torch.Tensor, w) -> torch.Tensor:
    """Rows of ``v`` (..., 3) dotted with the host 3-vector ``w``, as
    products summed in index order."""
    return v[..., 0] * float(w[0]) + v[..., 1] * float(w[1]) + v[..., 2] * float(w[2])


def fma_sum3(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3 of ``v * w`` as the fused chain
    fma(v2, w2, fma(v1, w1, v0 w0)): how XLA's compiled reductions and
    batched dots round (``addcmul`` rounds its product and sum once)."""
    acc = v[..., 0] * w[..., 0]
    acc = torch.addcmul(acc, v[..., 1], w[..., 1])
    return torch.addcmul(acc, v[..., 2], w[..., 2])


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float64 tensor, as NumPy and
    CUDA give it: PyTorch's CPU ``sqrt`` (MKL's vector library) is within
    an ulp but not always rounded to nearest.  One correction step on the
    exact residual x - y^2 (one fused multiply-add) rounds it; where
    ``sqrt`` is already right the step leaves it unchanged."""
    y = torch.sqrt(x)
    e = torch.addcmul(x, y, y, value=-1.0)
    return torch.where(y > 0, torch.addcmul(y, e, 0.5 / y), y)


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.cross over the last axis, in NumPy's operation order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of 3, summed in index order."""
    return torch.sqrt(sum3(v * v))


def quotient(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as NumPy divides, where ``a`` or ``b`` is a
    Python number: PyTorch computes tensor / number as a product with the
    number's reciprocal on CUDA, and number / tensor as one on every device,
    which can move the last bit.  The number goes in as a 0-d tensor of the
    other operand's dtype and device."""
    other = a if torch.is_tensor(a) else b

    def tensor(x):
        if torch.is_tensor(x):
            return x
        return torch.tensor(float(x), dtype=other.dtype, device=other.device)

    return tensor(a) / tensor(b)
