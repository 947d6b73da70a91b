"""Three-stage schedule: linear warmup, hold at peak, exponential decay
(counterpart of
``unicore_tpu/optim/lr_scheduler/tri_stage_lr_scheduler.py``; pure Python,
so the port's lrs equal the JAX package's)."""

import math

from . import UnicoreLRScheduler, register_lr_scheduler, single_lr


def tri_stage_lr(num_updates, *, init_lr, peak_lr, final_lr, warmup_steps,
                 hold_steps, decay_steps, decay_factor):
    if num_updates < warmup_steps:
        ramp = (peak_lr - init_lr) / warmup_steps if warmup_steps else 0
        return init_lr + ramp * num_updates
    t = num_updates - warmup_steps
    if t < hold_steps:
        return peak_lr
    t -= hold_steps
    if t <= decay_steps:
        return peak_lr * math.exp(-decay_factor * t)
    return final_lr


@register_lr_scheduler("tri_stage")
class TriStageLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        peak = single_lr(args, "tri-stage lr")
        self.peak_lr = peak
        self.init_lr = args.init_lr_scale * peak
        self.final_lr = args.final_lr_scale * peak

        if getattr(args, "phase_ratio", None) is not None:
            assert args.max_update > 0
            assert sum(args.phase_ratio) == 1, "phase ratios must add up to 1"
            ratios = args.phase_ratio
            self.warmup_steps = int(args.max_update * ratios[0])
            self.hold_steps = int(args.max_update * ratios[1])
            self.decay_steps = int(args.max_update * ratios[2])
        else:
            self.warmup_steps = args.warmup_steps
            self.hold_steps = args.hold_steps
            self.decay_steps = args.decay_steps
        assert self.warmup_steps + self.hold_steps + self.decay_steps > 0, (
            "please specify steps or phase_ratio"
        )

        self.decay_factor = -math.log(args.final_lr_scale) / self.decay_steps
        self.set_lr(self.init_lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--warmup-steps", default=4000, type=int, metavar="N",
            help="warmup the learning rate linearly for the first N updates",
        )
        parser.add_argument(
            "--hold-steps", default=20000, type=int, metavar="N",
            help="steps in hold stage",
        )
        parser.add_argument(
            "--decay-steps", default=60000, type=int, metavar="N",
            help="steps in decay stages",
        )
        parser.add_argument(
            "--init-lr-scale", default=0.01, type=float,
            help="initial learning rate scale during warmup phase",
        )
        parser.add_argument(
            "--final-lr-scale", default=0.01, type=float,
            help="final learning rate scale",
        )
        parser.add_argument(
            "--phase-ratio", default=None, type=eval,
            help="ratio for warmup/hold/decay phases (requires --max-update)",
        )

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.get_lr()

    def step_update(self, num_updates):
        self.set_lr(
            tri_stage_lr(
                num_updates,
                init_lr=self.init_lr,
                peak_lr=self.peak_lr,
                final_lr=self.final_lr,
                warmup_steps=self.warmup_steps,
                hold_steps=self.hold_steps,
                decay_steps=self.decay_steps,
                decay_factor=self.decay_factor,
            )
        )
        return self.get_lr()
