"""The check that nothing the benchmark runs has loaded JAX or the JAX
package.  Names are compared whole, by their top-level part (before the
first dot): ``repro_torch`` is the port and passes, ``repro`` is the JAX
package and fails."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (of ``names``, by default ``sys.modules``) whose
    top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
