"""Static cost model: parameter and FLOP counting for jitted functions.

Equivalent of the reference's graph-walking MAC counter
``print_macs_to_file`` (src/net/blocks.py:16-111): instead of walking TF ops,
we ask XLA itself via ``jax.jit(fn).lower(...).compile().cost_analysis()`` and
count parameters from the pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import numpy as np


def count_params(tree) -> int:
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, "shape"))


def param_breakdown(variables: Dict[str, Any]) -> Dict[str, int]:
    """Per-subnet parameter counts for an MV3D variables dict."""
    out = {}
    for name, v in variables.items():
        out[name] = count_params(v.get("params", v))
    out["total"] = sum(out.values())
    return out


def flops_of(fn: Callable, *example_args) -> Optional[float]:
    """Compiled-program FLOP estimate from XLA's cost analysis."""
    try:
        compiled = jax.jit(fn).lower(*example_args).compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost.get("flops", float("nan")))
    except Exception:
        return None


def print_macs_to_file(fn: Callable, example_args, variables,
                       path: str = "macs.txt"):
    """Write a cost report (parity with the reference's macs file output)."""
    lines = ["MV3D cost report", "=" * 40]
    for name, n in param_breakdown(variables).items():
        lines.append(f"params[{name}]: {n:,}")
    fl = flops_of(fn, *example_args)
    if fl is not None:
        lines.append(f"compiled flops (one step): {fl:,.0f}")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
