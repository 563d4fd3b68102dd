"""Model families: everything the harness knows of one kind of model, found
by the ``"family"`` a configuration file names.

A family is a package ``<SEARCH>/<family>/`` whose ``__init__`` has five
functions:

  * ``build(config, workload, seed, device) -> Built``: the weights from
    the seed, the engine over them (it serves through
    ``SttEngine.transcribe_pcm16``, so that the traffic drivers are
    shared), warmed up, and the seconds of each set-up step;
  * ``tap(engine)``: an object with ``bind(record)`` and ``remove()`` that
    puts what the engine served for the calling thread's request into
    ``record.windows``, in whatever form the family's ``judge`` reads;
  * ``describe(engine) -> dict``: what the set-up log reports of the
    engine (its captured graph classes);
  * ``judge(records, config, workload, seed, device, control=False) ->
    dict``: the numbers compared, over the records that came back without
    error, once the program's state is freed: ``windows`` (how many were
    judged) and every name of the cell's ``check.limits``; with
    ``control`` also the control's readings;
  * ``served_flops(config, record) -> float``: the model FLOPs of the work
    a record's request completed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

SEARCH = Path(__file__).resolve().parent  # where a family's folder is looked up
FUNCTIONS = ("build", "tap", "describe", "judge", "served_flops")
_NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


@dataclasses.dataclass
class Built:
    engine: object
    steps: dict  # seconds of each set-up step


def load(config: dict):
    """The family module that ``config`` names, imported once as
    ``benchmark.families.<family>``; refuses a configuration that names
    none, or a family without the five functions."""
    family = config.get("family")
    if not isinstance(family, str) or not _NAME.match(family):
        raise ValueError(f"configuration {config.get('name')!r} names no model family: "
                         f"\"family\" is {family!r}")
    name = f"{__name__}.{family}"
    mod = sys.modules.get(name)
    if mod is None:
        init = SEARCH / family / "__init__.py"
        if not init.is_file():
            raise ValueError(f"no model family {family!r}: {init} is not a file")
        spec = importlib.util.spec_from_file_location(
            name, init, submodule_search_locations=[str(init.parent)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise TypeError(f"model family {family!r} lacks {missing}")
    return mod
