# coding: utf-8
"""Step timing and profiler traces for the train command line, counterpart
of deepvoice3_pytorch_tpu/utils/profiling.py (which imports jax, so the port
keeps its own copy).

  * rss_mb — this process's resident set size;
  * StepTimer — wall-clock per-step timing with a warm-up skip (the first
    steps build the kernels and cuDNN's plans) and a rolling window;
  * TraceWindow — a torch.profiler trace of the CPU and the card over a step
    range, written as one Chrome trace (viewable in Perfetto) per window.
"""

import os
import time


def rss_mb(default=float("nan")):
    """Resident-set size of this process in MiB (Linux /proc); `default`
    when VmRSS is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return default


class StepTimer:
    """Rolling per-step timing; call tick() once per optimizer step."""

    def __init__(self, warmup=2, window=50):
        self.warmup = warmup
        self.window = window
        self._count = 0
        self._t_last = None
        self._times = []

    def tick(self):
        now = time.perf_counter()
        self._count += 1
        if self._t_last is not None and self._count > self.warmup:
            self._times.append(now - self._t_last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._t_last = now

    @property
    def seconds_per_step(self):
        if not self._times:
            return float("nan")
        return sum(self._times) / len(self._times)

    @property
    def steps_per_second(self):
        s = self.seconds_per_step
        return 1.0 / s if s == s and s > 0 else float("nan")

    def report(self, writer=None, step=None):
        if not self._times:
            return ""
        if writer is not None and step is not None:
            writer.add_scalar("perf/steps_per_sec", self.steps_per_second,
                              step)
            writer.add_scalar("perf/sec_per_step", self.seconds_per_step,
                              step)
        return "%.2f steps/s (%.0f ms/step)" % (
            self.steps_per_second, self.seconds_per_step * 1000.0)


class TraceWindow:
    """A torch.profiler trace over steps [start, start + num), written to
    `log_dir/trace_steps<start>-<stop - 1>.json`."""

    def __init__(self, log_dir, start_step, num_steps=5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None

    def maybe_start(self, step):
        if self.log_dir and self._prof is None and step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            print("profiler: tracing steps %d..%d -> %s"
                  % (self.start, self.stop - 1, self.log_dir))

    def maybe_stop(self, step):
        if self._prof is not None and step >= self.stop:
            self.close()

    def close(self):
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace_steps%d-%d.json"
                            % (self.start, self.stop - 1))
        prof.export_chrome_trace(path)
        print("profiler: trace written to %s" % path)
