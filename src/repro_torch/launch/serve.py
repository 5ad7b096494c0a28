"""Serving launcher: the continuous-batched LM decode loop.

``python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu``

The port of ``repro/launch/serve.py``'s ``DecodeServer``: a prefill
admits a request into a free KV-cache slot (batch 1, on the K4 attention
kernel); a decode step advances every active slot by one greedy token;
a finished sequence frees its slot.  Like the reference, ``step`` runs
every slot at one shared ``cache_len = max(lens[active]) - 1``, which is
right only when the active prompts have equal lengths.

:class:`DurableSessionLoop` is the graph-store analogue: a streaming-update
loop over a :class:`~repro_torch.core.session.DiffusionSession` with
write-ahead journaled commits, periodic snapshots, and
:class:`~repro_torch.runtime.fault_tolerance.PreemptionGuard`-driven
checkpoint-and-exit; the restart path is ``DiffusionSession.open(dir)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..core import chaos
from ..models import transformer
from ..runtime.fault_tolerance import PreemptionGuard


class DecodeServer:
    def __init__(self, cfg, params, batch_slots: int, max_len: int):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch = batch_slots
        self.device = params["embed"].device
        self.cache = transformer.init_cache(cfg, batch_slots, max_len,
                                            device=self.device)
        self.lens = np.zeros(batch_slots, np.int32)   # live tokens per slot
        self.active = np.zeros(batch_slots, bool)
        self.tokens = np.zeros((batch_slots, max_len), np.int32)

    def admit(self, prompt: np.ndarray) -> int | None:
        """Prefill a prompt into a free slot; returns the slot id (None
        when every slot is busy)."""
        free = np.where(~self.active)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        toks = torch.from_numpy(np.asarray(prompt, np.int64)[None]).to(
            self.device)
        logits, cache = transformer.prefill(self.params, toks, self.cfg,
                                            max_len=self.max_len)
        for kv in ("k", "v"):        # the slot's cache rows, in place
            self.cache[kv][:, slot] = cache[kv][:, 0]
        n = prompt.shape[0]
        self.lens[slot] = n
        self.tokens[slot, :n] = prompt
        self.tokens[slot, n] = int(torch.argmax(logits[0, -1]))
        self.lens[slot] += 1
        self.active[slot] = True
        return slot

    def step(self) -> None:
        """One decode step for every active slot (batched)."""
        if not self.active.any():
            return
        ln = int(self.lens[self.active].max()) - 1
        tok = self.tokens[np.arange(self.batch), np.maximum(self.lens - 1, 0)]
        tok = torch.from_numpy(tok.astype(np.int64)[:, None]).to(self.device)
        logits, self.cache = transformer.decode_step(
            self.params, tok, self.cache, ln, self.cfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for i in range(self.batch):
            if self.active[i] and self.lens[i] < self.max_len:
                self.tokens[i, self.lens[i]] = nxt[i]
                self.lens[i] += 1
                if self.lens[i] >= self.max_len:
                    self.active[i] = False

    def retire(self, slot: int) -> np.ndarray:
        self.active[slot] = False
        out = self.tokens[slot, : self.lens[slot]].copy()
        self.lens[slot] = 0
        return out


class DurableSessionLoop:
    """Preemption-safe streaming-update loop over a DiffusionSession.

    Each step stages one batch of graph updates, commits it (the commit
    journals before it mutates), and snapshots every ``snapshot_every``
    steps.  A SIGTERM/SIGINT observed by the guard stops the loop at the
    next step boundary with a final snapshot, so a preemption loses
    nothing: the journal holds every committed step since the last
    snapshot, and ``DiffusionSession.open(directory)`` replays it.

        loop = DurableSessionLoop(sess, "/data/store")
        loop.run(batches)           # installs/uninstalls its own guard

    ``batches`` is an iterable of callables, each staging one batch of
    ops on the session (``lambda s: s.add_edge(u, v, w)``).
    """

    def __init__(self, session, directory: str, snapshot_every: int = 16):
        self.session = session
        self.directory = directory
        self.snapshot_every = int(snapshot_every)
        self.steps = 0
        self.preempted = False
        session.save(directory)      # arm the journal + initial snapshot

    def step(self, stage) -> None:
        """Stage + commit one update batch (journaled), maybe snapshot."""
        stage(self.session)
        self.session.commit()
        self.steps += 1
        chaos.point("serve.step")
        if self.snapshot_every and self.steps % self.snapshot_every == 0:
            self.session.save()

    def run(self, batches, guard: PreemptionGuard | None = None) -> int:
        """Consume ``batches`` until exhausted or preempted; returns the
        number of steps completed.  A caller-provided guard is polled
        but not installed/uninstalled (the caller owns its lifetime)."""
        own = guard is None
        if own:
            guard = PreemptionGuard()
            guard.install()
        try:
            for stage in batches:
                self.step(stage)
                if guard.should_stop:
                    self.preempted = True
                    self.session.save()      # checkpoint-and-exit
                    break
            return self.steps
        finally:
            if own:
                guard.uninstall()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serve a few greedy requests.")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    mod = registry.get_module(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.make_config()
    params = transformer.init_params(cfg, seed=0, device=args.device)
    max_len = 48 if args.smoke else 2048
    srv = DecodeServer(cfg, params, batch_slots=args.requests,
                       max_len=max_len)

    rng = np.random.default_rng(0)
    t0 = time.time()
    slots = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
        slots.append(srv.admit(prompt))
    for _ in range(args.gen_tokens):
        srv.step()
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    n_tok = int(srv.lens.sum())
    dt = time.time() - t0
    print(f"served {args.requests} requests, {n_tok} total tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s) on {srv.device}")
    for s in slots:
        out = srv.retire(s)
        print(f"  slot {s}: {out[:12]}...")


if __name__ == "__main__":
    main()
