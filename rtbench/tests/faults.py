"""Faults planted in the program underneath a run, for the tests that show
the check catches them. Each is a function of pytest's `monkeypatch`."""

from toroidal_ray_tracing_tpu_torch.render import renderer
from toroidal_ray_tracing_tpu_torch.trace import wavefront


def unchanged_state(monkeypatch):
    """The bounce loop's step returns its state unchanged: S3 writes
    nothing, so no color is added and the loop stops."""
    monkeypatch.setattr(wavefront, "shade_finish", lambda *a, **k: None)


def half_batch(monkeypatch):
    """Half of each batch left out: a frame's later samples (the image the
    mean of the rest), else every second frame of a batch, else the lower
    half of a lone frame's rows."""
    real = renderer._finish

    def finish(traced, cam, params, width, height, off, outs, s, spp,
               chw=False):
        if spp > 1:
            if s < spp // 2:
                real(traced, cam, params, width, height, off, outs, s,
                     spp // 2, chw)
            return
        if (off // (width * height)) % 2:
            for o in outs:
                o.zero_()
            return
        real(traced, cam, params, width, height, off, outs, s, spp, chw)
        for o in outs:
            (o[:, height // 2:] if chw else o[height // 2:]).zero_()

    monkeypatch.setattr(renderer, "_finish", finish)


def altered_answer(monkeypatch):
    """Every frame's image altered where it is produced."""
    real = renderer._finish

    def finish(traced, cam, params, width, height, off, outs, s, spp,
               chw=False):
        real(traced, cam, params, width, height, off, outs, s, spp, chw)
        if s == spp - 1:
            outs[0].add_(0.01)

    monkeypatch.setattr(renderer, "_finish", finish)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
