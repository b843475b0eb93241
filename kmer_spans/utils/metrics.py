"""Per-phase metrics and tracing (SURVEY §5.1, §5.5).

The reference's only instrumentation is system.time() wrappers in test.R;
here every pipeline phase reports structured numbers — bases processed,
k-mers counted, regions emitted, phase wall-time and bases/s — via a
lightweight recorder, with optional jax.profiler traces around device
phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time

logger = logging.getLogger("kmer_spans")


@dataclasses.dataclass
class PhaseStat:
    name: str
    seconds: float
    bases: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def bases_per_sec(self) -> float:
        return self.bases / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Collects per-phase stats; emits one structured log line per phase."""

    def __init__(self, trace_dir: str | None = None):
        self.phases: list[PhaseStat] = []
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def phase(self, name: str, bases: int = 0, **extra):
        tracing = self.trace_dir is not None
        if tracing:
            import jax

            jax.profiler.start_trace(self.trace_dir)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if tracing:
                import jax

                jax.profiler.stop_trace()
            stat = PhaseStat(name=name, seconds=dt, bases=bases, extra=extra)
            self.phases.append(stat)
            logger.info(
                "phase=%s seconds=%.4f bases=%d bases_per_sec=%.3g %s",
                name, dt, bases, stat.bases_per_sec,
                " ".join(f"{k}={v}" for k, v in extra.items()),
            )

    def record(self, name: str, seconds: float, bases: int = 0, **extra):
        self.phases.append(
            PhaseStat(name=name, seconds=seconds, bases=bases, extra=extra)
        )

    def summary(self) -> dict:
        return {
            "phases": [
                {
                    "name": p.name,
                    "seconds": round(p.seconds, 6),
                    "bases": p.bases,
                    "bases_per_sec": round(p.bases_per_sec, 1),
                    **p.extra,
                }
                for p in self.phases
            ],
            "total_seconds": round(sum(p.seconds for p in self.phases), 6),
        }

    def dump(self) -> str:
        return json.dumps(self.summary())
