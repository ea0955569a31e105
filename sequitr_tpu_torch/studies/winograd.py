"""Winograd F(2x2, 3x3) convolution in plain tensor ops.

Counterpart of ``sequitr_tpu/studies/winograd.py``: each 2x2 output tile
costs 16 multiplies in the transform domain against 36 for the direct 3x3.

    Y = A^T [ (G g G^T) . (B^T d B) ] A          (Lavin & Gray, 2015)

The 16 input-transform components are +-1 combinations of 16 strided views,
the 16 per-component products contract C_in -> C_out (``torch.matmul``), and
the output transform is another +-combination. Differentiable through
autograd. Transforms run in f32; the products honor ``compute_dtype``. The
F(2,3) constants are exact in binary floating point (0, +-1, +-0.5), so f32
Winograd matches the direct f32 conv to about 1e-6 relative.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["winograd_conv3x3", "transform_weights"]

# F(2x2, 3x3) transform matrices (exact binary-float entries)
_B_T = np.array(
    [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32
)
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)
_A_T = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_in, C_out) -> transform-domain weights (4, 4, C_in, C_out)."""
    g = w.to(torch.float32)
    gm = torch.as_tensor(_G, device=w.device)
    u = torch.einsum("ij,jkco->ikco", gm, g)
    return torch.einsum("ikco,lk->ilco", u, gm)


def _row_combo(mat_row, items):
    """sum of coeff * item over a sparse row of 0 / +-1 coefficients."""
    out = None
    for coeff, item in zip(mat_row, items):
        if coeff == 0:
            continue
        term = item if coeff == 1 else (-item if coeff == -1 else float(coeff) * item)
        out = term if out is None else out + term
    return out


def winograd_conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """SAME 3x3 stride-1 conv of ``x`` (N, H, W, C_in), H and W even;
    ``w``: (3, 3, C_in, C_out). Returns float32 (N, H, W, C_out)."""
    n, h, w_img, c_in = x.shape
    c_out = w.shape[-1]
    if h % 2 or w_img % 2:
        raise ValueError(f"H, W must be even for F(2,3) tiling, got {h}x{w_img}")
    ty, tx = h // 2, w_img // 2

    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    # d[a][b] (a, b in 0..3): strided views so tile (i, j) sees rows 2i..2i+3
    d = [
        [xp[:, a : a + 2 * ty - 1 : 2, bcol : bcol + 2 * tx - 1 : 2, :] for bcol in range(4)]
        for a in range(4)
    ]
    # V[i][j] = sum_{a,b} B_T[i,a] * B_T[j,b] * d[a][b]
    dv = [
        [_row_combo(_B_T[i], [d[a][bcol] for a in range(4)]) for bcol in range(4)]
        for i in range(4)
    ]
    v = [[_row_combo(_B_T[j], dv[i]) for j in range(4)] for i in range(4)]

    u = transform_weights(w)  # (4, 4, C_in, C_out) f32

    # 16 component products: (N*ty*tx, C_in) @ (C_in, C_out)
    m = [
        [
            torch.matmul(
                v[i][j].to(compute_dtype).reshape(-1, c_in), u[i, j].to(compute_dtype)
            ).to(torch.float32).reshape(n, ty, tx, c_out)
            for j in range(4)
        ]
        for i in range(4)
    ]

    ma = [[_row_combo(_A_T[k], m[i]) for k in range(2)] for i in range(4)]
    y = [
        [_row_combo(_A_T[k], [ma[i][l] for i in range(4)]) for l in range(2)]
        for k in range(2)
    ]
    # interleave the 2x2 output phases back to (N, H, W, C_out)
    out = torch.stack(
        [torch.stack([y[0][0], y[0][1]], dim=3), torch.stack([y[1][0], y[1][1]], dim=3)],
        dim=2,
    )  # (N, ty, 2, tx, 2, C_out)
    out = out.reshape(n, h, w_img, c_out)
    if b is not None:
        out = out + b
    return out
