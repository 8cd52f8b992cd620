"""``nvidia-smi`` readings beside a window (copied from ``chip_smoke.py``):
the card's name and power limit, and the SM clock and power draw sampled
every 100 ms while a ``with`` block runs."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """"<name>, <power limit>" of card 0, or why it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing (exit {out.returncode})"


class SmiSampler:
    """Samples ``clocks.sm``, ``power.draw`` and ``power.limit`` every 100
    ms; ``summary`` gives min / median / max of each over the samples. The
    sampler process is ended and waited for when the block exits."""

    FIELDS = ("clocks.sm", "power.draw", "power.limit")

    def __enter__(self):
        self.summary = {"samples": 0}
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
                 "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        self.summary = {"samples": len(rows)}
        for i, name in enumerate(self.FIELDS):
            vals = sorted(r[i] for r in rows if len(r) == len(self.FIELDS))
            if vals:
                self.summary[name] = {"min": vals[0], "median": vals[len(vals) // 2],
                                      "max": vals[-1]}
        return False
