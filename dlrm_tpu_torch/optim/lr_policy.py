"""LR policy: linear warmup -> flat -> quadratic polynomial decay -> freeze
(the port's copy of dlrm_tpu/optim/lr_policy.py).

Host-side stateful scheduler with the exact semantics of LRPolicyScheduler
(dlrm_s_pytorch.py:169-203, duplicated at torchrec_dlrm/lr_scheduler.py:14-48),
including torch's _LRScheduler convention that the step count starts at 1 after
construction (the constructor applies one step).
"""

from __future__ import annotations

MIN_LR = 1.0e-7


class LRPolicy:
    def __init__(
        self,
        base_lr: float,
        num_warmup_steps: int = 0,
        decay_start_step: int = 0,
        num_decay_steps: int = 0,
    ):
        if decay_start_step < num_warmup_steps:
            raise ValueError("LR warmup must finish before the decay starts")
        self.base_lr = float(base_lr)
        self.num_warmup_steps = num_warmup_steps
        self.decay_start_step = decay_start_step
        self.decay_end_step = decay_start_step + num_decay_steps
        self.num_decay_steps = num_decay_steps
        self.step_count = 0
        self.last_lr = self.base_lr
        self.step()  # torch _LRScheduler applies an initial step

    def _compute(self) -> float:
        sc = self.step_count
        if sc < self.num_warmup_steps:
            scale = 1.0 - (self.num_warmup_steps - sc) / self.num_warmup_steps
            lr = self.base_lr * scale
            self.last_lr = lr
        elif self.decay_start_step <= sc < self.decay_end_step:
            decayed_steps = sc - self.decay_start_step
            scale = ((self.num_decay_steps - decayed_steps) / self.num_decay_steps) ** 2
            lr = max(MIN_LR, self.base_lr * scale)
            self.last_lr = lr
        else:
            # freeze at last lr after decay (or between warmup and decay)
            lr = self.last_lr if self.num_decay_steps > 0 else self.base_lr
        return lr

    def step(self) -> float:
        self.step_count += 1
        self.current_lr = self._compute()
        return self.current_lr

    @property
    def lr(self) -> float:
        return self.current_lr

    def state_dict(self) -> dict:
        return {"step_count": self.step_count, "last_lr": self.last_lr}

    def load_state_dict(self, sd: dict) -> None:
        self.step_count = int(sd["step_count"])
        self.last_lr = float(sd["last_lr"])
        self.current_lr = self._compute()
