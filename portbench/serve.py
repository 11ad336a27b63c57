"""The closed loop that drives the served entry.

A client keeps `in_flight` batches in flight: it calls the entry for the
next batch of the pool, copies the logits into a pinned host buffer of that
pool slot and records an event, then waits on the oldest batch's event.
So the client calls batch n as soon as batch n - in_flight has answered,
and a batch's latency, read on the device's clock, runs from the event
after batch n - in_flight's logits' copy to the event after its own: the
wait behind the batches in flight ahead of it included. The window's first
`in_flight` batches, with nothing ahead, run from the event recorded as
the client calls the entry for them. The service time, from that call's
event to the batch's end, is kept beside it. The host's clock times only
the whole window (and the spans of the calls, totalled).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Server:
    """Serves pool[j] with `call` round the pool, keeping for each slot the
    last answer served: its logits on the host and the entry's outputs."""

    def __init__(self, call, pool: torch.Tensor, in_flight: int):
        self.call, self.pool, self.in_flight = call, pool, in_flight
        self.cuda = pool.is_cuda
        self.host = [None] * pool.shape[0]
        self.last = [None] * pool.shape[0]
        self.served = 0  # batches served so far, which sets the next slot

    def _mark(self):
        """A point on the device's clock (a CUDA event recorded on the
        stream), or on the host's where there is no device."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def run(self, seconds: float = None, batches: int = None, annotate: bool = False) -> dict:
        """Serve until `seconds` have passed or `batches` were called, then
        wait for every batch in flight. Returns the window's images, its
        seconds (first call to last answer), the batches' latency and
        service ms, and the host seconds spent inside the entry."""
        span = torch.profiler.record_function if annotate else (lambda _: contextlib.nullcontext())
        pending = collections.deque()
        ends = collections.deque(maxlen=self.in_flight)  # the last batches' end marks
        latency_ms, service_ms, inside = [], [], 0.0
        done = attempted = 0
        t_first = time.perf_counter()
        t_end = t_first + (seconds if seconds is not None else float("inf"))
        count = 0

        def finish(rec):
            nonlocal done
            since, start, end, n = rec
            with span("portbench.wait"):
                if self.cuda:
                    end.synchronize()
            done += n
            latency_ms.append(self._ms(since, end))
            service_ms.append(self._ms(start, end))

        while (batches is None or count < batches) and time.perf_counter() < t_end:
            j = self.served % len(self.host)
            with span("portbench.batch"):
                start = self._mark()
                t0 = time.perf_counter()
                out = self.call(self.pool[j])
                inside += time.perf_counter() - t0
                logits = out["logits"]
                with span("portbench.copy"):
                    if self.host[j] is None:
                        self.host[j] = torch.empty(logits.shape, dtype=logits.dtype,
                                                   pin_memory=self.cuda)
                    self.host[j].copy_(logits, non_blocking=self.cuda)
                end = self._mark()
            self.last[j] = out
            since = ends[0] if len(ends) == self.in_flight else start
            ends.append(end)
            pending.append((since, start, end, logits.shape[0]))
            attempted += logits.shape[0]
            self.served += 1
            count += 1
            while len(pending) >= self.in_flight:
                finish(pending.popleft())
        while pending:
            finish(pending.popleft())
        seconds_ = time.perf_counter() - t_first
        return {"images": done, "attempted": attempted, "seconds": seconds_, "batches": count,
                "latency_ms": latency_ms, "service_ms": service_ms, "inside_s": inside, "t_first": t_first}

    def answers(self) -> list:
        """For each pool slot its last answer: the logits copied to the host in
        the window beside the entry's keep masks and scores; None if never served."""
        return [None if out is None else {"logits": host, "keep_masks": out["keep_masks"],
                                          "scores": out["scores"]}
                for host, out in zip(self.host, self.last)]
