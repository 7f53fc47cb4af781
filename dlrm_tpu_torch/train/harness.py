"""Training harness: the run()/inference() of the v1 trainer (the port of
dlrm_tpu/train/harness.py, single-process).

The reference training loop (dlrm_s_pytorch.py:1516-1781) and inference()
(:759-899): the epoch/batch loop with ms/it and loss lines, periodic eval
with accuracy or the MLPerf metric suite, checkpoint-on-best, resume with
data fast-forward (:1429-1437, 1535-1546), LR policy stepping, early stop on
accuracy/AUC thresholds (:1730-1760), gradient accumulation, debug-mode
parameter dumps and the MLPerf event log.

Batches reach the device through DevicePrefetcher (a producer thread and,
on the card, a side stream), one step ahead. The loop never waits on the
device between prints: each step's loss stays a device tensor until a print
boundary, and the ms/it it prints is host time from just before the step to
just after it.
"""

from __future__ import annotations

import copy
import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.device import process_count, resolve_device
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops import metrics as M
from dlrm_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.config import TrainConfig
from dlrm_tpu_torch.train import checkpoint as ckpt
from dlrm_tpu_torch.train.fused_step import (
    make_fused_grad_accum_train_step,
    make_fused_train_step,
    supports_fused,
)
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.train.step import (
    make_eval_step,
    make_grad_accum_train_step,
    make_train_step,
)
from dlrm_tpu_torch.utils import logging as obs


def _skip_batches(src, skip: int):
    """The first `skip` batches of one epoch pass without being
    materialized: a loader that enumerates indices (CriteoBinFile) skips at
    the index level (no disk read); anything else is islice'd (host batches
    built, never copied to the device). A prefetcher is unwrapped so the
    index-level skip still reaches its loader, then put back around the
    skipped iterable (one-shot: resume skips only the first pass of the
    resumed epoch)."""
    if isinstance(src, DevicePrefetcher):
        clone = copy.copy(src)
        clone.loader = _skip_batches(src.loader, skip)
        return clone
    if hasattr(src, "batch_indices") and hasattr(src, "read_batch"):
        ids = list(src.batch_indices())[skip:]
        return (src.read_batch(i) for i in ids)
    return itertools.islice(iter(src), skip, None)


class _group_batches:
    """Stack groups of `k` consecutive HostBatches on a new leading axis
    (a short trailing group is dropped, like the reference's incomplete
    accumulation window)."""

    def __init__(self, loader, k: int):
        self.loader = loader
        self.k = k

    def __len__(self):
        return len(self.loader) // self.k

    def __iter__(self):
        group: List[Any] = []
        for hb in self.loader:
            group.append(hb)
            if len(group) == self.k:
                yield HostBatch(
                    dense=np.stack([b.dense for b in group]),
                    idx=np.stack([b.idx for b in group]),
                    wt=(
                        None
                        if group[0].wt is None
                        else np.stack([b.wt for b in group])
                    ),
                    labels=np.stack([b.labels for b in group]),
                )
                group = []


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    epoch: int = 0
    iteration: int = 0  # within-epoch batch index
    total_iter: int = 0
    best_acc: float = 0.0
    best_auc: float = 0.0


def pick_train_step(model: DLRMModel, tc: TrainConfig):
    """The JAX Trainer's choice: the fused sparse step for plain tables
    with sgd, adagrad or rwsadagrad, the dense autograd step otherwise
    (QR, MD or weighted tables); each in its grad-accum variant under
    --mlperf-grad-accum-iter > 1."""
    fused = supports_fused(model) and tc.optimizer in (
        "sgd", "adagrad", "rwsadagrad")
    if tc.grad_accum_iter > 1:
        make = (make_fused_grad_accum_train_step if fused
                else make_grad_accum_train_step)
        return make(model, tc.optimizer, tc.grad_accum_iter, eps=tc.eps)
    make = make_fused_train_step if fused else make_train_step
    return make(model, tc.optimizer, eps=tc.eps)


class Trainer:
    """Single-device trainer. `device` is where params and batches live:
    the card unless the caller passes "cpu"."""

    def __init__(
        self,
        model: DLRMModel,
        train_cfg: TrainConfig,
        train_data: Iterable,
        test_data: Optional[Iterable] = None,
        scalar_log: Optional[obs.ScalarLogger] = None,
        mlperf: Optional[obs.MLPerfLogger] = None,
        train_step=None,
        eval_step=None,
        to_device: Optional[Callable] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.tc = train_cfg
        self.train_data = train_data
        self.test_data = test_data
        self.scalar_log = scalar_log or obs.ScalarLogger(None)
        self.mlperf = mlperf or obs.MLPerfLogger(
            enabled=train_cfg.mlperf_logging)
        self.train_step = train_step or pick_train_step(model, train_cfg)
        self.eval_step = eval_step or make_eval_step(model)
        self.to_device = to_device or (lambda hb: hb.to_device(self.device))
        self._run_stop_emitted = False
        self.lr_policy = LRPolicy(
            train_cfg.learning_rate,
            train_cfg.lr_num_warmup_steps,
            train_cfg.lr_decay_start_step,
            train_cfg.lr_num_decay_steps,
        )

    def _prefetch(self, loader):
        return DevicePrefetcher(loader, self.to_device, device=self.device)

    # ------------------------------------------------------------------ init

    def init_state(self) -> TrainState:
        """Params from the global numpy stream seeded with
        --numpy-rand-seed (the reference's init, the JAX package's numbers);
        QR tables, which have no numpy init, from a torch.Generator seeded
        with the same flag. Then --load-model's checkpoint, if any."""
        tc = self.tc
        np.random.seed(tc.numpy_rand_seed)
        try:
            params = self.model.init_params_numpy(device=self.device)
        except NotImplementedError:
            params = self.model.init_params(seed=tc.numpy_rand_seed,
                                            device=self.device)
        opt_state = init_opt_state(tc.optimizer, params)
        state = TrainState(params=params, opt_state=opt_state)
        if tc.load_model:
            params, opt_state, meta = ckpt.load_checkpoint(
                tc.load_model, params, opt_state
            )
            state = TrainState(
                params=params,
                opt_state=opt_state,
                epoch=int(meta.get("epoch", 0)),
                iteration=int(meta.get("iteration", 0)),
                total_iter=int(meta.get("total_iter", 0)),
                best_acc=float(meta.get("best_acc", 0.0)),
                best_auc=float(meta.get("best_auc", 0.0)),
            )
            self.lr_policy.load_state_dict(
                meta.get("lr_policy", self.lr_policy.state_dict())
            )
            print(
                f"Loaded model from {tc.load_model}: epoch {state.epoch} "
                f"iteration {state.iteration}"
            )
        return state

    # ------------------------------------------------------------------ train

    def train(self, state: Optional[TrainState] = None) -> TrainState:
        tc = self.tc
        state = state or self.init_state()
        if tc.inference_only:
            # the reference's inference-only run prints the accuracy line
            # through inference() (dlrm_s_pytorch.py:873-898, called at :1458)
            results = self.evaluate(state)
            acc = results.get("accuracy", 0.0)
            line = (
                f"Testing at - {state.total_iter}/{state.total_iter} of "
                f"epoch {state.epoch}, accuracy {acc * 100:.3f} %"
            )
            if tc.mlperf_logging and "roc_auc" in results:
                line += f", auc {results['roc_auc']:.6f}"
            print(line)
            return state
        # the INIT block the CLI opened (CACHE_CLEAR + INIT_START,
        # dlrm_s_pytorch.py:1036-1040) closes as training begins; then the
        # submission and hyperparameter block (:1097-1102, 1389-1396,
        # 1487-1507), the LR logged twice as the reference does
        self.mlperf.end(obs.INIT_STOP)
        self.mlperf.start(obs.RUN_START)
        self.mlperf.submission("dlrm")
        self.mlperf.event(obs.SEED, value=tc.numpy_rand_seed)
        self.mlperf.event(obs.GLOBAL_BATCH_SIZE, value=tc.mini_batch_size)
        self.mlperf.event(obs.OPT_BASE_LR, value=tc.learning_rate)
        self.mlperf.event(
            obs.OPT_LR_WARMUP_STEPS, value=tc.lr_num_warmup_steps
        )
        self.mlperf.event(
            "sgd_opt_base_learning_rate", value=tc.learning_rate
        )
        self.mlperf.event(
            "lr_decay_start_steps", value=tc.lr_decay_start_step
        )
        self.mlperf.event(
            "sgd_opt_learning_rate_decay_steps", value=tc.lr_num_decay_steps
        )
        self.mlperf.event("sgd_opt_learning_rate_decay_poly_power", value=2)
        print("time/loss/accuracy (if enabled):")
        nbatches = len(self.train_data)
        skip_epoch, skip_iter = state.epoch, state.iteration
        stop = False
        self._run_stop_emitted = False
        for epoch in range(state.epoch, tc.nepochs):
            self.mlperf.start(
                obs.BLOCK_START,
                metadata={"first_epoch_num": epoch + 1, "epoch_count": 1},
            )
            self.mlperf.start(
                obs.EPOCH_START, metadata={"epoch_num": epoch + 1}
            )
            accum_losses, accum_time, accum_count = [], 0.0, 0
            train_src = self.train_data
            if hasattr(train_src, "set_epoch"):
                # the shuffle permutation follows the TRAINER's epoch, so a
                # resume fast-forward skips the batches the run trained
                train_src.set_epoch(epoch)
            if tc.grad_accum_iter > 1:
                # groups of accum_iter host batches on a leading axis, which
                # the grad-accum step consumes at once (the reference skips
                # zero_grad/step except every Nth batch,
                # dlrm_s_pytorch.py:1604-1621)
                train_src = _group_batches(
                    self.train_data, tc.grad_accum_iter
                )
                nbatches = len(train_src)
            # fast-forward UPSTREAM of the prefetcher: skipped batches are
            # never copied to the device, nor read where the loader can
            # enumerate its indices
            skip = skip_iter if epoch == skip_epoch else 0
            if skip:
                train_src = _skip_batches(train_src, skip)
            for it, batch in enumerate(self._prefetch(train_src), start=skip):
                t0 = time.perf_counter()
                lr = self.lr_policy.lr
                state.params, state.opt_state, loss, _ = self.train_step(
                    state.params, state.opt_state, batch, lr
                )
                self.lr_policy.step()
                state.iteration = it + 1
                state.total_iter += 1
                # the loss stays on the device until a print boundary
                accum_losses.append(loss)
                accum_count += 1
                accum_time += (time.perf_counter() - t0) * 1000
                if (it + 1) % tc.print_freq == 0 or it + 1 == nbatches:
                    # one read of the device for the window's losses,
                    # summed in float64 in step order
                    losses = torch.stack(accum_losses).double().cpu().tolist()
                    gl = float(sum(losses)) / accum_count
                    gt = accum_time / accum_count if tc.print_time else -1.0
                    wall = (
                        time.strftime(" (%H:%M)") if tc.print_wall_time else ""
                    )
                    print(
                        f"Finished training it {it + 1}/{nbatches} of epoch "
                        f"{epoch}, {gt:.2f} ms/it, loss {gl:.6f}{wall}"
                    )
                    self.scalar_log.add_scalar("Train/Loss", gl,
                                               state.total_iter)
                    accum_losses = []
                    accum_time = 0.0
                    accum_count = 0

                # periodic eval (dlrm_s_pytorch.py:1686-1715)
                if (
                    tc.test_freq > 0
                    and self.test_data is not None
                    and (it + 1) % tc.test_freq == 0
                ):
                    stop = self._eval_and_maybe_stop(state, epoch, it + 1,
                                                     nbatches)
                    if stop:
                        break
            state.epoch = epoch + 1
            state.iteration = 0
            self.mlperf.end(obs.EPOCH_STOP, metadata={"epoch_num": epoch + 1})
            self.mlperf.end(
                obs.BLOCK_STOP, metadata={"first_epoch_num": epoch + 1}
            )
            if stop:
                break
        if tc.test_freq <= 0 and self.test_data is not None:
            # state.epoch is already past the last epoch; the 0-based index
            # keeps epoch_num as the in-loop formula gives it
            self._eval_and_maybe_stop(
                state, state.epoch - 1, state.total_iter, state.total_iter
            )
        # the reference's RUN_STOP (dlrm_s_pytorch.py:1752-1781): SUCCESS at
        # the auc-threshold stop inside the loop; a run that never clears
        # the threshold ends ABORTED
        if (not self._run_stop_emitted
                and state.best_auc <= tc.mlperf_auc_threshold):
            self.mlperf.end(obs.RUN_STOP, metadata={"status": "aborted"})
            self._run_stop_emitted = True
        return state

    # ------------------------------------------------------------------- eval

    def evaluate(self, state: TrainState,
                 epoch_num: Optional[float] = None) -> Dict[str, float]:
        """inference() (dlrm_s_pytorch.py:759-899): the test set's scores,
        padded rows (label < 0) dropped, then the rounded-prediction
        accuracy, or with --mlperf-logging the full metric dict (AUC,
        accuracy, precision, recall, F1, AP)."""
        if process_count() > 1:
            raise NotImplementedError(
                "the multi-process evaluation (the AUC histogram summed "
                "across ranks) is not ported yet (ROADMAP queue A item 11)"
            )
        tc = self.tc
        meta = {} if epoch_num is None else {"epoch_num": epoch_num}
        self.mlperf.start(obs.EVAL_START, metadata=meta)
        scores: List[torch.Tensor] = []
        labels: List[torch.Tensor] = []
        for batch in self._prefetch(self.test_data):
            scores.append(self.eval_step(state.params, batch).reshape(-1))
            labels.append(batch.labels.reshape(-1))
        s = torch.cat(scores).float().cpu().numpy()
        lbl = torch.cat(labels).float().cpu().numpy()
        mask = lbl >= 0  # drop padded rows
        s, lbl = s[mask], lbl[mask]
        if tc.mlperf_logging:
            results = M.binary_metrics(s, lbl)
        else:
            # rounded-prediction accuracy (dlrm_s_pytorch.py:814-823)
            results = {"accuracy": float(np.mean(np.round(s) == lbl))}
        self.mlperf.end(obs.EVAL_STOP, metadata=meta)
        # MLPerf DLRM's eval metric is the AUC (the reference gates RUN_STOP
        # on it, dlrm_s_pytorch.py:1745); plain accuracy where no AUC is
        # computed
        self.mlperf.event(
            obs.EVAL_ACCURACY,
            value=results.get("roc_auc", results.get("accuracy")),
            metadata=meta,
        )
        return results

    def _eval_and_maybe_stop(self, state: TrainState, epoch: int, it: int,
                             nbatches: int = 0) -> bool:
        tc = self.tc
        # epoch_num_float, dlrm_s_pytorch.py:1675
        epoch_num = (it / nbatches if nbatches else 0.0) + epoch + 1
        results = self.evaluate(state, epoch_num=epoch_num)
        acc = results.get("accuracy", 0.0)
        auc = results.get("roc_auc", float("nan"))
        is_best = acc > state.best_acc
        if is_best:
            state.best_acc = acc
        if not np.isnan(auc) and auc > state.best_auc:
            state.best_auc = auc
        # "Testing at - j+1/nbatches of epoch k" (dlrm_s_pytorch.py:873-898)
        line = (
            f"Testing at - {it}/{nbatches} of epoch {epoch}, "
            f"accuracy {acc * 100:.3f} %, best {state.best_acc * 100:.3f} %"
        )
        if tc.mlperf_logging:
            line += f", auc {auc:.6f}, best auc {state.best_auc:.6f}"
        print(line)
        self.scalar_log.add_scalar("Test/Acc", acc, state.total_iter)
        if tc.mlperf_logging:
            for k, v in results.items():
                self.scalar_log.add_scalar(
                    f"mlperf-metrics-test/{k}", v, state.total_iter
                )
        if is_best and tc.save_model:
            self.save(state, tc.save_model)
        # early stop thresholds (dlrm_s_pytorch.py:1730-1760)
        if (tc.mlperf_acc_threshold > 0
                and state.best_acc > tc.mlperf_acc_threshold):
            print(f"MLPerf testing accuracy threshold "
                  f"{tc.mlperf_acc_threshold} reached, stop training")
            return True
        if (
            tc.mlperf_auc_threshold > 0
            and state.best_auc > tc.mlperf_auc_threshold
        ):
            print(f"MLPerf testing auc threshold {tc.mlperf_auc_threshold} "
                  "reached, stop training")
            # the reference emits RUN_STOP success at the threshold stop
            # itself (dlrm_s_pytorch.py:1752-1762)
            self.mlperf.end(obs.RUN_STOP, metadata={"status": "success"})
            self._run_stop_emitted = True
            return True
        return False

    # ------------------------------------------------------------- checkpoint

    def save(self, state: TrainState, path: str) -> None:
        ckpt.save_checkpoint(
            path,
            state.params,
            state.opt_state,
            meta={
                "epoch": state.epoch,
                "iteration": state.iteration,
                "total_iter": state.total_iter,
                "best_acc": state.best_acc,
                "best_auc": state.best_auc,
                "lr_policy": self.lr_policy.state_dict(),
            },
        )
        print(f"Saved model to {path}")


def dump_parameters(params, precision: int = 5) -> None:
    """Debug-mode parameter dump (dlrm_s_pytorch.py:1222-1274 prints every
    initial and updated parameter): each leaf's path, then its values, in
    the JAX package's order (dict keys sorted)."""
    np.set_printoptions(precision=precision)
    for key, leaf in ckpt.flatten_with_paths(params).items():
        print(key)
        print(leaf.detach().cpu().numpy())
