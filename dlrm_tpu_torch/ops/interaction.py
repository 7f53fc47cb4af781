"""Feature interaction (the port of dlrm_tpu/ops/interaction.py).

dot: pairwise dot products of the (dense ++ pooled-embedding) feature
vectors, lower triangle in the reference's order, concatenated after the
dense vector (dlrm_s_pytorch.py:483-515).

cat: plain concatenation (dlrm_s_pytorch.py:505-507).

dcn: DCN-v2 low-rank cross network on the concatenated features (torchrec
DLRM_DCN, torchrec_dlrm/dlrm_main.py:598-617).

projection: two branches map the concatenated features to F_1 and F_2
vectors of width d; their pairwise dots follow the dense vector (torchrec
DLRM_Projection, torchrec_dlrm/dlrm_main.py:618-635). A branch is torchrec's
MLP (InteractionProjectionArch: a ReLU after every layer, branch 2 read
[d, F2]) or, in the JAX package's simplified form, one linear map (branch 2
read [F2, d] and transposed).

Every product takes fp32 sums and is rounded to the compute dtype once
(ops/mlp.py::matmul_f32), as the JAX package's
preferred_element_type=float32 einsums are.
"""

from __future__ import annotations

import functools
from typing import List, Union

import numpy as np
import torch

from dlrm_tpu_torch.ops import quantized as Q
from dlrm_tpu_torch.ops.mlp import apply_mlp, matmul_f32


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


def _branch(feats: torch.Tensor, branch: Union[torch.Tensor, List[dict]],
            dtype: torch.dtype) -> torch.Tensor:
    """One branch in the compute dtype: a weight [F*d, p*d] is the
    simplified form's linear map; a list of layers is torchrec's MLP,
    bf16 or quantized (quantize_mlps) like the towers."""
    if isinstance(branch, torch.Tensor):
        return matmul_f32(feats, branch).to(dtype)
    if Q.is_quantized_mlp(branch):
        return Q.apply_mlp_quantized(branch, feats).to(dtype)
    return apply_mlp(branch, feats)


def projection_interaction(
    x: torch.Tensor,  # [B, d]
    ly: torch.Tensor,  # [B, T, d]
    branch1: Union[torch.Tensor, List[dict]],
    branch2: Union[torch.Tensor, List[dict]],
) -> torch.Tensor:  # [B, d + F1*F2]
    """Y = branch1(c) [B, F1, d] and Z [B, d, F2] from c = flatten(x, ly):
    torchrec's MLP branches give Z as branch2(c).reshape(B, d, F2), the
    simplified form's weights as branch2(c).reshape(B, F2, d) transposed.
    Each branch rounds to the compute dtype a layer; bmm(Y, Z) is taken
    in fp32 and cast once, as in dot_interaction."""
    batch, d = x.shape
    feats = torch.cat([x[:, None, :], ly], dim=1).reshape(batch, -1)
    y = _branch(feats, branch1, x.dtype).reshape(batch, -1, d)
    z = _branch(feats, branch2, x.dtype)
    z = (z.reshape(batch, -1, d).transpose(1, 2)
         if isinstance(branch2, torch.Tensor) else z.reshape(batch, d, -1))
    out = torch.bmm(y.float(), z.float())  # [B, F1, F2]
    return torch.cat([x, out.reshape(batch, -1).to(x.dtype)], dim=1)
