"""What holds a dry-run cell's peak: the storages live at a rank's peak on
``meta``, grouped by the op that made them, their shape and dtype.

    PYTHONPATH=src python -m repro_torch.tools.peak_holders \\
        --arch rwkv6-7b --shape train_4k [--multi-pod] [--top 8]

Runs ``launch/dryrun.py::run_cell`` (nothing saved, no card) with its
``MetaMemory`` replaced by one that also records which op made each
storage, and prints the cell's line, then the largest groups live at the
peak: GiB, op, shape, dtype.  The live set is taken again whenever the
peak has risen by ``--step`` GiB since it was last taken, so it is the
peak's to within that step.  The cell's arguments (params, batch,
optimizer state, cache) are counted apart, as the accounting counts
them.
"""

from __future__ import annotations

import argparse
import collections

import torch

from repro_torch.launch import dryrun


class HolderMemory(dryrun.MetaMemory):
    """``MetaMemory`` that also keeps each storage's maker and the live
    set near the peak."""

    step = 2**28

    def __init__(self, arguments=()):
        super().__init__(arguments)
        self.maker, self.at_peak, self._op, self._taken = {}, {}, None, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _see(self, t):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key in self.live and self.live[key][0].expired():
                self.current -= self.live.pop(key)[1]   # its address reused
            if key not in self.live and key not in self.known:
                self.maker[key] = (self._op, tuple(t.shape),
                                   str(t.dtype).replace("torch.", ""))
        super()._see(t)
        if self.peak - self._taken >= self.step:
            self._sweep()
            self._taken = self.peak
            self.at_peak = {k: (self.maker.get(k, ("?", (), "?")), n)
                            for k, (_, n) in self.live.items()}

    def groups(self):
        out = collections.Counter()
        for maker, n in self.at_peak.values():
            out[maker] += n
        return out


def holders(arch: str, shape: str, multi_pod: bool, step_gib: float):
    """(run_cell's result, the ``HolderMemory`` of the counted step)."""
    made = []

    class Recorded(HolderMemory):
        step = int(step_gib * 2**30)

        def __init__(self, arguments=()):
            super().__init__(arguments)
            made.append(self)

    keep = dryrun.MetaMemory
    dryrun.MetaMemory = Recorded
    try:
        res = dryrun.run_cell(arch, shape, multi_pod, save=False)
    finally:
        dryrun.MetaMemory = keep
    return res, made[-1] if made else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--step", type=float, default=0.25,
                    help="GiB the peak rises before the live set is taken")
    args = ap.parse_args(argv)
    res, mem = holders(args.arch, args.shape, args.multi_pod, args.step)
    if res["status"] != "ok" or mem is None:
        raise SystemExit(f"{args.arch} {args.shape}: {res['status']} "
                         f"{res.get('reason') or res.get('error', '')}")
    args_gib = res["memory"]["argument_total"] / 2**30
    groups = mem.groups()
    print(f"{args.arch} {args.shape} {res['mesh']}: peak "
          f"{res['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB a rank"
          f" = arguments {args_gib:.2f} + live {mem.peak / 2**30:.2f}; "
          f"live near the peak {sum(groups.values()) / 2**30:.2f} GiB")
    for (op, shape, dtype), n in groups.most_common(args.top):
        print(f"  {n / 2**30:9.2f} GiB  {op} {shape} {dtype}")


if __name__ == "__main__":
    main()
