"""Public entry points for per-grid (de)hierarchization.

Port of ``repro.kernels.ops``.  ``method``:

  * ``"func"``   — numpy brute force (the paper's `Func` baseline; oracle
                   use only, runs on the host)
  * ``"ref"``    — torch unrolled level loop (`Ind` layout analog)
  * ``"gather"`` — one-shot linear-operator gather (torch)
  * ``"pole"``   — the pole kernels (paper-faithful level loop per pole),
                   every axis passed in place
  * ``"matmul"`` — the per-axis dense operator kernel
  * ``"fused"``  — the fused tail kernel, then the axis-0 operator kernel
  * ``"auto"``   — ``"fused"`` when every axis has at most 2047 points,
                   else ``"ref"`` (the reference's rule, kept so that each
                   shape takes the reference's method)

The transforms run where the tensor lies: on a CUDA tensor the kernel
methods launch their CUDA kernels, on a CPU tensor their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import hierarchize as hk
from repro_torch.kernels import ref

# The reference's threshold (priced for its TPU's compute/memory ridge);
# what it should be on a GPU is an open question, kept equal here so that
# every shape takes the reference's method.
_MATMUL_MAX_N = 2047

__all__ = ["hierarchize", "dehierarchize"]


def _per_axis(x: torch.Tensor, fn) -> torch.Tensor:
    """Apply the 1-D transform ``fn(x, axis)`` along every axis in turn."""
    for axis in range(x.ndim):
        x = fn(x, axis)
    return x


def _bundled(fn):
    """``fn`` on an (N, B) bundle made a transform along any axis: the
    axis is moved to the front and the others flattened onto columns (a
    copy for every axis but the first).  Row 3's kernel takes a bundle."""
    def along(x: torch.Tensor, axis: int) -> torch.Tensor:
        moved = torch.movedim(x, axis, 0)
        shape = moved.shape
        flat = fn(moved.reshape(shape[0], -1))
        return torch.movedim(flat.reshape(shape), 0, axis)
    return along


def _auto(x: torch.Tensor) -> str:
    return "fused" if max(x.shape) <= _MATMUL_MAX_N else "ref"


def _brute_force(x: torch.Tensor, fn) -> torch.Tensor:
    out = x.detach().cpu().double().numpy()
    for axis in range(out.ndim):
        out = fn(out, axis)
    return torch.from_numpy(out).to(device=x.device, dtype=x.dtype)


def hierarchize(x: torch.Tensor, method: str = "auto", *,
                reduced_op: bool = True) -> torch.Tensor:
    """d-dimensional nodal -> hierarchical base change."""
    if method == "auto":
        method = _auto(x)
    if method == "func":
        return _brute_force(x, ref.hierarchize_1d_bruteforce)
    if method == "ref":
        return ref.hierarchize_nd_ref(x, reduced_op=reduced_op)
    if method == "gather":
        for axis in range(x.ndim):
            x = ref.hierarchize_1d_gather(x, axis)
        return x
    if method == "pole":
        return _per_axis(x, lambda y, axis: hk.hier_pole(
            y, reduced_op=reduced_op, axis=axis))
    if method == "matmul":
        return _per_axis(x, _bundled(hk.apply_axis_matmul))
    if method == "fused":
        return hk.hierarchize_nd_fused(x)
    raise ValueError(f"unknown method {method!r}")


def dehierarchize(a: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """d-dimensional hierarchical -> nodal base change (inverse)."""
    if method == "auto":
        method = _auto(a)
    if method == "func":
        return _brute_force(a, ref.dehierarchize_1d_bruteforce)
    if method == "ref":
        return ref.dehierarchize_nd_ref(a)
    if method == "pole":
        return _per_axis(a, lambda y, axis: hk.dehier_pole(y, axis=axis))
    if method == "matmul":
        return _per_axis(a, _bundled(
            lambda f: hk.apply_axis_matmul(f, inverse=True)))
    if method == "fused":
        return hk.dehierarchize_nd_fused(a)
    raise ValueError(f"unknown method {method!r}")
