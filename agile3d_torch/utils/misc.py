"""Console metric logging and the wandb key bootstrap (counterpart of the
JAX package's ``utils/misc.py``, which replaces the reference's
``utils/misc.py:33-252`` MetricLogger / SmoothedValue).

The meters' window, global average and ``log_every`` lines are the JAX
package's. ``reduce_dict`` and ``synchronize_between_processes`` reduce
over the processes of the default ``torch.distributed`` group (the
data-parallel ranks, ``parallel/train.py``), and are the identity in one
process.
"""

from __future__ import annotations

import datetime
import getpass
import os
import sys
import time
from collections import defaultdict, deque


def _all_reduce_sum(values: list[float]) -> list[float] | None:
    """The sums of ``values`` over the processes of the default
    ``torch.distributed`` group, in float64; None without a group of more
    than one process."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.tolist()


class SmoothedValue:
    """Track a series with a moving window and global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum (count, total) over the processes; the window stays local.
        A no-op in one process."""
        ct = _all_reduce_sum([float(self.count), self.total])
        if ct is not None:
            self.count, self.total = int(ct[0]), float(ct[1])

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


def reduce_dict(d: dict, average: bool = True) -> dict:
    """A dict of scalars summed (``average``: averaged) over the processes;
    the keys must be the same in every process. In one process, a copy."""
    import torch.distributed as dist

    keys = sorted(d)
    summed = _all_reduce_sum([float(d[k]) for k in keys])
    if summed is None:
        return dict(d)
    if average:
        summed = [v / dist.get_world_size() for v in summed]
    return dict(zip(keys, summed))


class MetricLogger:
    def __init__(self, delimiter: str = "  ", log=print):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log = log

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Yield from ``iterable``, logging every ``print_freq`` items and
        at the last one: the meters, an ETA and the time per item."""
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i - 1)))
                    self.log(f"{header} [{i}/{total}] eta: {eta} "
                             f"{self} time: {iter_time}")
                else:
                    self.log(f"{header} [{i}] {self} time: {iter_time}")
            end = time.time()
        elapsed = datetime.timedelta(seconds=int(time.time() - start))
        self.log(f"{header} Total time: {elapsed}")


def setup_wandb(keys_folder: str = "wandb_keys") -> bool:
    """The wandb API key for this process (reference utils/misc.py:
    388-403): already in the environment or in a ``wandb login`` session,
    cached per user under ``<keys_folder>/<user>_wandb.key``, or asked for
    once on a TTY and cached. Returns True when a key is available (and
    sets ``WANDB_API_KEY`` in this process's environment), else False; the
    caller then logs nowhere."""
    if os.environ.get("WANDB_API_KEY"):
        return True
    netrc = os.path.expanduser("~/.netrc")
    try:  # an existing `wandb login` session also counts
        with open(netrc) as f:
            if "api.wandb.ai" in f.read():
                return True
    except OSError:
        pass
    key_path = os.path.join(keys_folder, f"{getpass.getuser()}_wandb.key")
    if os.path.exists(key_path):
        with open(key_path) as f:
            key = f.read().strip()
    elif sys.stdin.isatty():
        key = input("[You need to firstly setup and login wandb] Please "
                    "enter your wandb key (https://wandb.ai/authorize):"
                    ).strip()
        if not key:
            return False
        os.makedirs(keys_folder, exist_ok=True)
        with open(key_path, "w") as f:
            f.write(key)
    else:
        return False
    os.environ["WANDB_API_KEY"] = key
    return True
