"""Faults planted in the port, to show that a cell's check catches them:
a step that returns its state unchanged, half of the batch left out, and
an answer altered where it is produced (a pose, a pick, a gradient).  One
chip, so no exchange between chips can be left out.  Each fault is a
context manager that patches the port's module and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def _step_fault(wrap):
    from mocha_sigasia2023_torch.runtime import stream

    def make(real):
        def make_step(*args, **kw):
            return wrap(real(*args, **kw))
        return make_step
    return _patched(stream, "make_stream_step", make)


def stale_step():
    """The stream step returns the carry it was given."""
    def wrap(step):
        def stale(consts, carry, x, generator=None):
            _, out = step(consts, carry, x, generator)
            return carry, out
        return stale
    return _step_fault(wrap)


def altered_pose():
    """One joint of every served pose moved 5 cm where the step makes it."""
    def wrap(step):
        def altered(consts, carry, x, generator=None):
            carry, out = step(consts, carry, x, generator)
            out = dict(out)
            out["ik_pos"] = out["ik_pos"].clone()
            out["ik_pos"][0, 3, 1] += 0.05
            return carry, out
        return altered
    return _step_fault(wrap)


def altered_pick():
    """Every match moved half the database away before the step reads it."""
    def wrap(step):
        def altered(consts, carry, x, generator=None):
            M = consts.cha_encoded.shape[0]
            return step(consts, carry, dict(x, nn_idx=(x["nn_idx"] + M // 2)
                                            % M), generator)
        return altered
    return _step_fault(wrap)


def half_batch():
    """Serving: the second half of the streams never served (the first
    half's answers in their place)."""
    from mocha_sigasia2023_torch.runtime import stream

    def make(real):
        def make_runner(*args, **kw):
            runner = real(*args, **kw)

            def half(frame0, xs, generator=None, char_ids=None):
                out = runner(frame0, xs, generator, char_ids=char_ids)
                S = out["ik_pos"].shape[1]
                for v in out.values():
                    v[:, S // 2:] = v[:, :S - S // 2][:, :S // 2]
                return out
            return half
        return make_runner
    return _patched(stream, "make_batch_runner", make)


def _trainer():
    from mocha_sigasia2023_torch.train import trainer
    return trainer.GeneratorTrainer


def no_update():
    """Training: the step leaves the weights, AdamW and the EMA as they
    were."""
    return _patched(_trainer(), "update", lambda real: lambda self: None)


def half_training_batch():
    """Training: the step takes the mean over the first half of each
    batch."""
    def make(real):
        def half(self, bs, bc, norm, generator=None):
            n = len(bs["X"]) // 2
            return real(self, {k: v[:n] for k, v in bs.items()},
                        {k: v[:n] for k, v in bc.items()}, norm, generator)
        return half
    return _patched(_trainer(), "train_step", make)


def altered_gradient():
    """Training: the first leaf's gradient doubled before the update."""
    def make(real):
        def altered(self):
            p = next(self.gen.parameters())
            if p.grad is not None:
                p.grad.mul_(2.0)
            real(self)
        return altered
    return _patched(_trainer(), "update", make)


def late_altered_gradient():
    """Training: the first leaf's gradient doubled before the update from
    the fourth update on, after set-up's first steps: a change that
    engages only in steady state."""
    def make(real):
        def altered(self):
            p = next(self.gen.parameters())
            if self.step >= 3 and p.grad is not None:
                p.grad.mul_(2.0)
            real(self)
        return altered
    return _patched(_trainer(), "update", make)


SERVING = {"stale_step": stale_step, "altered_pose": altered_pose,
           "altered_pick": altered_pick, "half_batch": half_batch}
TRAINING = {"no_update": no_update, "half_batch": half_training_batch,
            "altered_gradient": altered_gradient,
            "late_altered_gradient": late_altered_gradient}


def for_kind(kind: str):
    """The faults a cell of this traffic kind can have."""
    if kind == "train":
        return TRAINING
    if kind == "live":          # one stream: no half batch
        return {k: v for k, v in SERVING.items() if k != "half_batch"}
    return SERVING
