"""Feature interaction (the port of dlrm_tpu/ops/interaction.py's dot
interaction): pairwise dot products of the (dense ++ pooled-embedding)
feature vectors, lower triangle in the reference's order, concatenated after
the dense vector (dlrm_s_pytorch.py:483-515). The cat, dcn and projection
interactions are not ported yet (ROADMAP queue A item 8)."""

from __future__ import annotations

import functools

import numpy as np
import torch


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
