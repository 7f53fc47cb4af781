"""Feature interaction (the port of dlrm_tpu/ops/interaction.py).

dot: pairwise dot products of the (dense ++ pooled-embedding) feature
vectors, lower triangle in the reference's order, concatenated after the
dense vector (dlrm_s_pytorch.py:483-515).

cat: plain concatenation (dlrm_s_pytorch.py:505-507).

dcn: DCN-v2 low-rank cross network on the concatenated features (torchrec
DLRM_DCN, torchrec_dlrm/dlrm_main.py:598-617).

projection: both branches project the concatenated features linearly into
p_i vectors of width d; their pairwise dots follow the dense vector
(torchrec DLRM_Projection, torchrec_dlrm/dlrm_main.py:618-635).

Every product takes fp32 sums and is rounded to the compute dtype once
(ops/mlp.py::matmul_f32), as the JAX package's
preferred_element_type=float32 einsums are.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from dlrm_tpu_torch.ops.mlp import matmul_f32


def _tril_flat_indices(num_features: int, itself: bool) -> np.ndarray:
    """Flattened [f*F+g] indices in the reference's iteration order
    (dlrm_s_pytorch.py:499-501): li=[i for i in range(F) for j in range(i+off)]."""
    offset = 1 if itself else 0
    f = num_features
    li = [i for i in range(f) for _ in range(i + offset)]
    lj = [j for i in range(f) for j in range(i + offset)]
    return np.asarray(li, dtype=np.int64) * f + np.asarray(lj, dtype=np.int64)


@functools.lru_cache(maxsize=16)
def _tril_index(num_features: int, itself: bool,
                device: torch.device) -> torch.Tensor:
    """_tril_flat_indices on `device`, copied there once (a copy from
    pageable host memory on every call would wait on the card)."""
    return torch.from_numpy(_tril_flat_indices(num_features, itself)).to(device)


def dot_interaction(
    x: torch.Tensor,  # [B, d] bottom-MLP output
    ly: torch.Tensor,  # [B, T, d] pooled embeddings
    itself: bool = False,
) -> torch.Tensor:  # [B, d + num_pairs]
    """The pairwise dots are taken in fp32 (exact products of bf16 inputs,
    fp32 sums) and cast back to x's dtype once, as the JAX package does."""
    batch, d = x.shape
    feats = torch.cat([x[:, None, :], ly], dim=1)  # [B, F, d]
    num_f = feats.shape[1]
    f32 = feats.float()
    z = torch.bmm(f32, f32.transpose(1, 2))  # [B, F, F]
    flat = _tril_index(num_f, itself, x.device)
    z_flat = z.reshape(batch, num_f * num_f).index_select(1, flat)
    return torch.cat([x, z_flat.to(x.dtype)], dim=1)


def cat_interaction(x: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, ly.reshape(x.shape[0], -1)], dim=1)


def low_rank_cross_net(
    params: List[dict],  # per layer: {"v": [r, n], "w": [n, r], "b": [n]}
    x0: torch.Tensor,  # [B, n] concatenated features
) -> torch.Tensor:
    """DCN-v2 low-rank cross layers: x_{l+1} = x0 * (W_l @ (V_l @ x_l) + b_l)
    + x_l. Both products round to x0's dtype, then the bias (cast to it),
    the product with x0 and the residual each round there, op by op."""
    dtype = x0.dtype
    xl = x0
    for layer in params:
        low = matmul_f32(xl, layer["v"].t()).to(dtype)
        up = matmul_f32(low, layer["w"].t()).to(dtype)
        xl = x0 * (up + layer["b"].to(dtype)) + xl
    return xl


def projection_interaction(
    x: torch.Tensor,  # [B, d]
    ly: torch.Tensor,  # [B, T, d]
    w1: torch.Tensor,  # [F*d, p1*d] branch-1 projection
    w2: torch.Tensor,  # [F*d, p2*d] branch-2 projection
) -> torch.Tensor:  # [B, d + p1*p2]
    """The two projections round to the compute dtype; their pairwise
    dots are taken in fp32 and cast once, as in dot_interaction."""
    batch, d = x.shape
    feats = torch.cat([x[:, None, :], ly], dim=1).reshape(batch, -1)
    p1 = matmul_f32(feats, w1).to(x.dtype).reshape(batch, -1, d)
    p2 = matmul_f32(feats, w2).to(x.dtype).reshape(batch, -1, d)
    z = torch.bmm(p1.float(), p2.float().transpose(1, 2))  # [B, p1, p2]
    return torch.cat([x, z.reshape(batch, -1).to(x.dtype)], dim=1)
