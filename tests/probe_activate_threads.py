"""Probe: the exact (policy-free) activations of the port against the
reference's, repeated under several torch thread counts.

    PYTHONPATH=src python tests/probe_activate_threads.py [--reps 50]

Runs ``test_torch_cordic_core.py::test_activate_exact_path_and_policies``'s
comparison ``--reps`` times at ``torch.set_num_threads`` 1, 2 and 6 on the
test's own inputs, and prints one JSON line per thread count: for each
AF the entries beyond the test's bar (atol 1e-6, rtol 2e-6) summed over
the repetitions, and the largest relative difference among finite,
non-zero reference values.  It also prints the share of those inputs on
which ``torch.tanh`` and ``F.gelu(approximate="tanh")`` differ from
``jnp.tanh`` and ``jax.nn.gelu`` in any bit, the functions the port's
exact path used before it spelled out the reference's.  Not collected by
pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro.core import activations as ja  # noqa: E402
from repro_torch.core import activations as ta  # noqa: E402
from test_torch_cordic_core import _af_inputs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    x = _af_inputs(np.random.default_rng(0))   # the test's ``rng`` fixture
    want = {n: np.asarray(ja.activate(jnp.asarray(x), n))
            for n in ta.SUPPORTED_AFS}
    before = torch.get_num_threads()
    try:
        for threads in (1, 2, 6):
            torch.set_num_threads(threads)
            rows = {}
            for name in ta.SUPPORTED_AFS:
                w = want[name]
                live = np.isfinite(w) & (w != 0)
                bad, rel = 0, 0.0
                for _ in range(args.reps):
                    g = ta.activate(torch.from_numpy(x), name).numpy()
                    d = np.abs(g.astype(np.float64) - w)
                    bad += int(np.sum(d > 1e-6 + 2e-6 * np.abs(w)))
                    rel = max(rel, float(np.max(d[live] / np.abs(w[live]))))
                rows[name] = {"beyond_bar": bad, "max_rel": rel}
            print(json.dumps({"threads": threads, "reps": args.reps,
                              "afs": rows}))
    finally:
        torch.set_num_threads(before)
    t = torch.from_numpy(x)
    old = {"tanh": (torch.tanh(t).numpy(), np.asarray(jnp.tanh(x))),
           "gelu": (torch.nn.functional.gelu(t, approximate="tanh").numpy(),
                    np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)))}
    print(json.dumps({"inputs": int(x.size), "torch_differs_share": {
        n: float(np.mean(a != b)) for n, (a, b) in old.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
