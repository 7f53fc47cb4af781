"""The DLRM model over a plain dict of tensors (the port of the fused-table
path of dlrm_tpu/models/dlrm.py).

Parameters keep the JAX package's tree so they cross the bridge unchanged:
{"emb": {"stacked": [rows, d]}, "bot": [{"w": [n_in, n_out], "b": [n_out]},
...], "top": [...]}. The model object holds only static config. Ported: the
stacked plain tables, the dot interaction, and the top/bottom towers with
BCE/MSE/WBCE; QR and MD tables and the cat, dcn and projection interactions
raise NotImplementedError (ROADMAP queue A item 8).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.ops.interaction import dot_interaction
from dlrm_tpu_torch.ops.mlp import apply_mlp, init_mlp

Params = Dict


class DLRMModel:
    """Static-config holder; all state lives in the params dict."""

    def __init__(self, cfg: DLRMConfig):
        self.cfg = cfg
        # the stacked-table path needs plain tables of uniform width
        self.fused = cfg.qr is None and cfg.md is None
        if self.fused:
            sizes = np.asarray(cfg.table_sizes, dtype=np.int64)
            self.row_offsets = np.concatenate(
                [[0], np.cumsum(sizes)[:-1]]
            ).astype(np.int32)
            self.total_rows = int(sizes.sum())

    def _check_supported(self):
        if not self.fused:
            raise NotImplementedError(
                "QR/MD tables are not ported yet (ROADMAP queue A item 8)"
            )
        if self.cfg.interaction != "dot":
            raise NotImplementedError(
                f"the {self.cfg.interaction!r} interaction is not ported yet "
                "(ROADMAP queue A item 8)"
            )
        if self.cfg.weighted_pooling is not None:
            raise NotImplementedError(
                "weighted pooling is not ported yet (ROADMAP queue A item 8)"
            )

    def init_params(self, seed: int = 0, device="cuda") -> Params:
        """Random init with the reference's distributions, drawn on `device`
        from a torch.Generator seeded with `seed`: tables
        U(-sqrt(1/n), sqrt(1/n)) (dlrm_s_pytorch.py:280-282), MLP weights
        N(0, sqrt(2/(m+n))), biases N(0, sqrt(1/m)) (:221-225). torch's
        generator gives other numbers than jax.random from the same seed;
        tests carry the JAX package's params across with bridge.py."""
        self._check_supported()
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        tables = []
        for n in cfg.table_sizes:
            bound = math.sqrt(1.0 / n)
            u = torch.rand((n, cfg.embedding_dim), generator=gen, device=dev)
            tables.append(u * (2 * bound) - bound)
        return {
            "emb": {"stacked": torch.cat(tables, dim=0)},
            "bot": init_mlp(gen, cfg.mlp_bot, dev),
            "top": init_mlp(gen, cfg.ln_top, dev),
        }

    def forward_from_pooled(self, params: Params, dense: torch.Tensor,
                            ly: torch.Tensor):
        """Dense tower + interaction + top MLP given pooled embeddings
        [B, T, d] -> (probability, logits). Split out so the streamed train
        step can differentiate with respect to the pooled activations
        instead of the table. The top MLP's last layer stays linear and
        gives fp32 logits; the sigmoid is applied to them
        (dlrm_s_pytorch.py:1293). Its operands keep the compute dtype's
        values, but the product is taken in fp32, as the JAX package's
        preferred_element_type=float32 does: a bf16 product would round
        every logit to 8 bits and tie the eval scores that AUROC ranks."""
        self._check_supported()
        cfg = self.cfg
        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        x = apply_mlp(params["bot"], dense.to(dtype), cfg.sigmoid_bot)
        z = dot_interaction(x, ly.to(x.dtype), cfg.interaction_itself)
        hidden = apply_mlp(params["top"][:-1], z, sigmoid_layer=-1)
        last = params["top"][-1]
        w = last["w"].to(hidden.dtype)
        logits = torch.matmul(hidden.float(), w.float()) + last["b"]
        p = torch.sigmoid(logits)
        if 0.0 < cfg.loss_threshold < 1.0:
            p = torch.clamp(p, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
        return p, logits


def per_example_loss(
    cfg: DLRMConfig,
    probs: torch.Tensor,
    labels: torch.Tensor,
    logits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE / BCE / weighted-BCE per example. BCE from logits is
    softplus(z) - t*z with an exact softplus (logaddexp(z, 0));
    F.softplus turns linear above its threshold and is not used."""
    t = labels.float()
    if cfg.loss == "mse":
        return torch.square(probs - t)
    if logits is not None and not (0.0 < cfg.loss_threshold < 1.0):
        z = logits.float()
        per = torch.logaddexp(z, torch.zeros_like(z)) - t * z
    else:
        eps = 1e-7  # >= fp32 ulp at 1.0 so the clip actually bites
        p = torch.clamp(probs, eps, 1.0 - eps)
        per = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    if cfg.loss == "bce":
        return per
    # wbce: per-sample weight selected by the integer target
    w1, w0 = float(cfg.loss_weights[1]), float(cfg.loss_weights[0])
    return torch.where(t >= 0.5, w1, w0) * per


def masked_mean(per: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over REAL rows only: a label < 0 marks a pad row, which adds
    nothing to the loss or its gradients."""
    t = labels.float().reshape(per.shape)
    valid = (t >= 0.0).float()
    denom = torch.clamp(valid.sum(), min=1.0)
    return (per * valid).sum() / denom
