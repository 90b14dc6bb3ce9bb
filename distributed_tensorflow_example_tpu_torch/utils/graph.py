"""The training step's graph dump under ``--profile`` and
``--profile_steps``: the port's counterpart of the JAX package's
``utils/hlo.py``.

JAX writes, beside its profiler trace, the train step's StableHLO as
traced (``train_step.stablehlo.txt``) and the optimized HLO the TPU runs
(``train_step.hlo.txt``).  A torch step is no compiled program; what
stands for them here:

- ``<name>.aten.txt``: every ATen operator one real step issued
  (forward, backward, update), in order, each with its inputs' and
  outputs' shapes, dtypes and devices, recorded by a
  ``TorchDispatchMode`` around the step the run takes anyway (no copy,
  no second step, no extra draw from a generator), and a line for each
  hand-written kernel launch in its place: the kernels go through
  ctypes, never through the dispatcher, so the wrappers report them
  through ``ops/_counts`` (the wrapper's name, its tensors, its launch
  plan; on CPU tensors, that its plain version ran, whose operators
  follow);
- ``<name>.cudagraph.dot``: where the step is a captured CUDA graph
  (the MLP's device-resident epoch, ``parallel/epoch.py``), the graph's
  ``debug_dump``: the kernels and copies the card replays.  The
  recording runs while the step is captured, so its Python runs once,
  at capture time.

``GraphDump`` is armed once a run on the chief; the first step that
runs through ``record`` (or, for a captured graph, under ``recording``
and then ``write``) is dumped, the later ones run as they are.  A dump
never raises, as JAX's ``dump_graph`` never does: a failure prints
``NOTE: graph dump for 'train_step' failed: ...`` and the run goes on.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import _counts

# why a dump has no .cudagraph.dot, unless its caller says more
NO_GRAPH = ("the step ran eagerly; only the MLP's device-resident epoch "
            "on the card is a captured CUDA graph")
_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
           torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8",
           torch.bool: "bool"}


def _describe(x) -> str:
    """One argument or result: a tensor as ``dtype[shape] device``, a
    sequence item by item, anything else by its ``repr`` (cut at 40
    characters)."""
    if isinstance(x, torch.Tensor):
        dt = _DTYPES.get(x.dtype, str(x.dtype).replace("torch.", ""))
        return f"{dt}{list(x.shape)} {x.device}"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in x) + "]"
    text = repr(x)
    return text if len(text) <= 40 else text[:37] + "..."


class _AtenLog(TorchDispatchMode):
    """Each ATen operator, run as it is, then its line appended; an
    error in the line's making is kept (the operator's result stands)."""

    def __init__(self, dump: "GraphDump"):
        super().__init__()
        self.dump = dump

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.dump._line(lambda: "{}({}) -> {}".format(
            func, ", ".join([_describe(a) for a in args]
                            + [f"{k}={_describe(v)}"
                               for k, v in kwargs.items()]),
            _describe(out)))
        return out


class GraphDump:
    """The run's one graph dump into ``logs_path``: ``pending`` until a
    step was recorded; ``paths`` the files written."""

    def __init__(self, logs_path: str, name: str = "train_step"):
        self.logs_path, self.name = logs_path, name
        self.pending = True
        self.paths: List[str] = []
        self.launches: dict = {}    # {wrapper: kernel lines}
        self._lines: List[str] = []
        self._error: Optional[BaseException] = None
        # a process's first dispatch mode imports much of torch (seconds
        # of host time): paid here, when the run arms its dump, and not
        # inside the step it records
        with _AtenLog(self):
            torch.zeros(())
        self._lines = []

    def _line(self, make: Callable[[], str]) -> None:
        if self._error is not None:
            return
        try:
            self._lines.append(make())
        except Exception as e:      # the dump must not break the step
            self._error = e

    def _kernel(self, name: str, tensors: Sequence, plan, launched: bool
                ) -> None:
        def make():
            args = ", ".join(_describe(t) for t in tensors)
            if not launched:
                return (f"PLAIN {name}({args}): the kernel's plain "
                        f"version ran (CPU tensors); its operators follow")
            self.launches[name] = self.launches.get(name, 0) + 1
            return f"KERNEL {name}({args}) plan={plan!r}"
        self._line(make)

    @contextlib.contextmanager
    def recording(self):
        """Record the operators and kernel launches issued inside."""
        self._lines, self._error, self.launches = [], None, {}
        old = _counts.set_recorder(self._kernel)
        try:
            with _AtenLog(self):
                yield
        finally:
            _counts.set_recorder(old)

    def record(self, step: Callable, *args, **kwargs) -> Any:
        """``step(*args, **kwargs)``, recorded and written while the dump
        is pending; its result either way."""
        if not self.pending:
            return step(*args, **kwargs)
        with self.recording():
            out = step(*args, **kwargs)
        self.write(graph=None)
        return out

    def write(self, graph=None, why_no_graph: str = "") -> List[str]:
        """Write what ``recording`` saw, and ``graph``'s debug dump (a
        ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``, captured
        and instantiated) when given, else print one line saying why
        there is none.  Never raises."""
        self.pending = False
        try:
            if self._error is not None:
                raise self._error
            os.makedirs(self.logs_path, exist_ok=True)
            path = os.path.join(self.logs_path, f"{self.name}.aten.txt")
            head = [
                f"# {self.name}: the ATen operators of one training step "
                f"(forward, backward, update) in the order they ran, with "
                f"each hand-written kernel's launch in its place",
                f"# torch {torch.__version__}; kernel launches "
                f"{dict(sorted(self.launches.items()))}; "
                f"{len(self._lines)} lines"]
            with open(path, "w") as f:
                f.write("\n".join(head + self._lines) + "\n")
            self.paths.append(path)
            if graph is not None:
                path = os.path.join(self.logs_path,
                                    f"{self.name}.cudagraph.dot")
                graph.debug_dump(path)
                if not os.path.exists(path):
                    raise RuntimeError(f"CUDAGraph.debug_dump wrote no {path}")
                self.paths.append(path)
            else:
                print(f"NOTE: no {self.name}.cudagraph.dot: "
                      f"{why_no_graph or NO_GRAPH}")
        except Exception as e:
            print(f"NOTE: graph dump for {self.name!r} failed: {e}")
        self._lines = []
        return self.paths


def dump_graph(step: Callable, args: Sequence, logs_path: str,
               name: str = "train_step") -> tuple:
    """``step(*args)`` recorded and its dump written into ``logs_path``:
    ``(the step's result, the paths written)``.  The step runs once,
    whether or not the dump succeeds; the dump never raises."""
    dump = GraphDump(logs_path, name)
    out = dump.record(step, *args)
    return out, dump.paths


__all__ = ["GraphDump", "dump_graph", "NO_GRAPH"]
