"""Faults a one-card serving cell can have, planted in the program under a
run to show that the check that decides ``correct`` fails them: a step
that leaves the KV state unchanged, half of a decode batch left out (its
rows given the first half's tokens), a token altered where it is sampled.
A one-card cell has no exchange between chips to leave out. Each plant
takes ``patch(owner, name, value)``, pytest's ``monkeypatch.setattr`` or
``planted``'s own."""
from __future__ import annotations

import contextlib


def state_unchanged(patch) -> None:
    from repro_torch.engine.kv_cache import PagedKVCache
    patch(PagedKVCache, "write_layer", lambda self, *a, **k: None)


def half_batch_left_out(patch) -> None:
    from repro_torch.engine.engine import ServingEngine
    orig = ServingEngine._decode_finish

    def finish(self, rids, nxt, dt):
        h = len(rids) // 2
        nxt = list(nxt)
        nxt[len(rids) - h: len(rids)] = nxt[:h]
        return orig(self, rids, nxt, dt)
    patch(ServingEngine, "_decode_finish", finish)


def token_altered(patch) -> None:
    from repro_torch.engine.engine import ServingEngine
    orig = ServingEngine._sample

    def sample(self, logits, step, sampling):
        t = orig(self, logits, step, sampling).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    patch(ServingEngine, "_sample", sample)


PLANTS = {f.__name__: f for f in (state_unchanged, half_batch_left_out, token_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the duration."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)
    PLANTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
