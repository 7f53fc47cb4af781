"""Typed model and training-run configuration (the port's copy of
dlrm_tpu/config.py: DLRMConfig, its sub-configs and TrainConfig; the port
imports nothing of dlrm_tpu).

Mirrors the semantics of the reference CLI surface (dlrm_s_pytorch.py:904-1021 and
torchrec_dlrm/dlrm_main.py:75-311) as a frozen dataclass with the same derived-shape
logic (top-MLP input dim computed from the interaction arity,
dlrm_s_pytorch.py:1150-1170) and the same consistency checks
(dlrm_s_pytorch.py:1173-1210).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def _as_tuple(xs) -> Tuple[int, ...]:
    return tuple(int(x) for x in xs)


@dataclass(frozen=True)
class QRConfig:
    """Quotient-remainder embedding compression (tricks/qr_embedding_bag.py).

    Tables with more than `threshold` rows are replaced by a quotient table of
    ceil(n / collisions) rows and a remainder table of `collisions` rows whose
    lookups are combined by `operation` in {"mult", "add", "concat"}.
    """

    collisions: int = 4
    threshold: int = 200
    operation: str = "mult"

    def __post_init__(self):
        if self.operation not in ("mult", "add", "concat"):
            raise ValueError(f"qr operation {self.operation!r} not supported")
        if self.collisions < 1:
            raise ValueError("qr collisions must be >= 1")


@dataclass(frozen=True)
class MDConfig:
    """Mixed-dimension embeddings (tricks/md_embedding_bag.py).

    Per-table embedding dims assigned by the alpha-power rule on row counts
    (md_solver, tricks/md_embedding_bag.py:22-58); tables above `threshold`
    rows get a smaller dim plus a learned projection back to the base dim.
    """

    temperature: float = 0.3
    threshold: int = 200
    round_dims: bool = False


@dataclass(frozen=True)
class DCNConfig:
    """DCN-v2 low-rank cross network (torchrec DLRM_DCN variant,
    torchrec_dlrm/dlrm_main.py:598-617)."""

    num_layers: int = 3
    low_rank_dim: int = 512


@dataclass(frozen=True)
class DLRMConfig:
    """Full model + input-format configuration.

    Field names follow the reference flags:
      embedding_dim      <- --arch-sparse-feature-size (m_spa)
      table_sizes        <- --arch-embedding-size (ln_emb)
      mlp_bot            <- --arch-mlp-bot (ln_bot)
      mlp_top            <- --arch-mlp-top (ln_top before the derived input dim)
      interaction        <- --arch-interaction-op (dot|cat|dcn|projection)
      interaction_itself <- --arch-interaction-itself
      num_indices_per_lookup <- --num-indices-per-lookup (static hot-size H of the
                                padded multi-hot batch layout)
    """

    embedding_dim: int = 2
    table_sizes: Tuple[int, ...] = (4, 3, 2)
    mlp_bot: Tuple[int, ...] = (4, 3, 2)
    mlp_top: Tuple[int, ...] = (4, 2, 1)
    interaction: str = "dot"
    interaction_itself: bool = False
    # Static max indices per (table, sample) lookup; ragged bags are padded to
    # this length with zero-weight entries (XLA needs static shapes).
    num_indices_per_lookup: int = 10

    # Interaction variants.
    dcn: Optional[DCNConfig] = None
    # projection interaction: number of output features per projected interaction
    # (torchrec DLRM_Projection interaction_branch{1,2}_layer_sizes analog).
    proj_interaction_dims: Optional[Tuple[int, ...]] = None

    # Embedding tricks.
    qr: Optional[QRConfig] = None
    md: Optional[MDConfig] = None
    # "fixed" or "learned" per-index pooling weights (dlrm_s_pytorch.py:337-340).
    weighted_pooling: Optional[str] = None

    # Loss.
    loss: str = "mse"  # mse | bce | wbce (dlrm_s_pytorch.py:384-397)
    loss_weights: Tuple[float, float] = (1.0, 1.0)
    loss_threshold: float = 0.0  # clamp of the predicted probability

    # Activation placement (sigmoid on the given layer index, -1 = none for bot;
    # the top MLP always ends with sigmoid in the reference: sigmoid_top =
    # ln_top.size - 2, dlrm_s_pytorch.py:1292-1293).
    sigmoid_bot: int = -1

    # Compute dtype for activations/matmuls ("float32" or "bfloat16"); params
    # and the loss are always kept in float32.
    compute_dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "table_sizes", _as_tuple(self.table_sizes))
        object.__setattr__(self, "mlp_bot", _as_tuple(self.mlp_bot))
        object.__setattr__(self, "mlp_top", _as_tuple(self.mlp_top))
        if self.interaction not in ("dot", "cat", "dcn", "projection"):
            raise ValueError(f"interaction {self.interaction!r} not supported")
        if self.loss not in ("mse", "bce", "wbce"):
            raise ValueError(f"loss {self.loss!r} not supported")
        if self.interaction == "dcn" and self.dcn is None:
            object.__setattr__(self, "dcn", DCNConfig())
        if self.qr is not None and self.md is not None:
            raise ValueError("qr and md embedding tricks are mutually exclusive")
        # Same consistency check as dlrm_s_pytorch.py:1173-1178.
        if self.mlp_bot[-1] != self.embedding_dim and self.md is None:
            raise ValueError(
                f"bottom-MLP output dim ({self.mlp_bot[-1]}) must equal "
                f"embedding dim ({self.embedding_dim})"
            )

    # ---- derived shapes (dlrm_s_pytorch.py:1150-1170) ----

    @property
    def num_dense(self) -> int:
        return self.mlp_bot[0]

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def num_features(self) -> int:
        """num sparse + 1 dense feature vector."""
        return self.num_tables + 1

    @property
    def interaction_output_dim(self) -> int:
        f = self.num_features
        d = self.mlp_bot[-1]
        if self.interaction == "dot":
            pairs = (f * (f + 1)) // 2 if self.interaction_itself else (f * (f - 1)) // 2
            return pairs + d
        if self.interaction == "cat":
            return f * d
        if self.interaction == "dcn":
            return f * d  # cross-net preserves the concat width
        if self.interaction == "projection":
            assert self.proj_interaction_dims is not None
            # dense passthrough + pairwise dots of two projected branches
            b1, b2 = self.proj_interaction_dims[-1], self.proj_interaction_dims[-1]
            return d + b1 * b2
        raise AssertionError(self.interaction)

    @property
    def ln_top(self) -> Tuple[int, ...]:
        """Full top-MLP layer sizes with the derived input dim prepended."""
        return (self.interaction_output_dim,) + self.mlp_top

    @property
    def md_dims(self) -> Tuple[int, ...]:
        """Per-table embedding dims under the MD trick (base dim otherwise)."""
        if self.md is None:
            return tuple(self.embedding_dim for _ in self.table_sizes)
        from dlrm_tpu_torch.ops.md_solver import md_solver

        return md_solver(
            self.table_sizes,
            alpha=self.md.temperature,
            d0=self.embedding_dim,
            round_dim=self.md.round_dims,
        )

    def replace(self, **kw) -> "DLRMConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-run configuration (flag parity with dlrm_s_pytorch.py run())."""

    mini_batch_size: int = 1
    test_mini_batch_size: int = -1
    nepochs: int = 1
    learning_rate: float = 0.01
    optimizer: str = "sgd"  # sgd | adagrad | rwsadagrad
    # Adagrad denominator epsilon; None -> torch default 1e-10 (v2's --eps
    # passes 1e-8 for torchrec parity, dlrm_main.py:200-205)
    eps: Optional[float] = None
    # LR policy (dlrm_s_pytorch.py:169-203)
    lr_num_warmup_steps: int = 0
    lr_decay_start_step: int = 0
    lr_num_decay_steps: int = 0
    # Data
    data_generation: str = "random"  # random | synthetic | dataset
    data_size: int = 1
    num_batches: int = 0
    numpy_rand_seed: int = 123
    round_targets: bool = False
    num_indices_per_lookup_fixed: bool = False
    rand_data_dist: str = "uniform"
    rand_data_min: float = 0.0
    rand_data_max: float = 1.0
    rand_data_mu: float = -1.0
    rand_data_sigma: float = 1.0
    # Loop control
    print_freq: int = 1
    test_freq: int = -1
    print_time: bool = False
    print_wall_time: bool = False  # append " (HH:MM)" (dlrm_s_pytorch.py:1655)
    debug_mode: bool = False
    grad_accum_iter: int = 1  # --mlperf-grad-accum-iter
    mlperf_logging: bool = False
    mlperf_acc_threshold: float = 0.0
    mlperf_auc_threshold: float = 0.0
    # Checkpointing
    save_model: str = ""
    load_model: str = ""
    inference_only: bool = False

    @property
    def eval_batch_size(self) -> int:
        return (
            self.test_mini_batch_size
            if self.test_mini_batch_size > 0
            else self.mini_batch_size
        )

    @property
    def num_train_batches(self) -> int:
        if self.num_batches > 0:
            return self.num_batches
        return int(math.ceil(self.data_size / self.mini_batch_size))
