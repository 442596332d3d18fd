"""ttd-lint over the port: the static checkers and the runtime sanitizers
(the JAX package's ``runtime/lint``).  Both halves read one annotation
registry.

- ``registry``: the declarations (``@thread_role``, ``@locks_held``,
  ``@dispatch_critical``, ``@compile_site``, ``@memory_budget``,
  ``_GUARDED_BY`` with ``@concurrency_guarded``) the code carries;
- the static checkers (``core.run_lint``; the CLI is
  ``python -m tensorflow_train_distributed_torch.tools.ttd_lint``, and
  ``tests/test_torch_ttd_lint.py`` holds the port and ``chip_smoke.py``
  at zero findings):

  - ``concurrency``: every access to a ``_GUARDED_BY`` attribute holds
    its lock on every path the class's ``@thread_role`` entry points
    reach;
  - ``dispatch``: no host sync (``.item()``, ``.tolist()``, ``.cpu()``,
    ``float()`` of a tensor, ``torch.cuda.synchronize()``, a tensor in a
    branch test, ...) and no host nondeterminism inside
    ``@dispatch_critical`` functions;
  - ``kill-switch`` (``flags``): every ``TTD_*`` name the port reads is
    documented in the README's port section and exercised by a port
    test;
  - ``prometheus``: counters end in ``_total``, histograms in
    ``_seconds``, and every ``ttd_*`` metric is in the README's port
    section;
  - ``memcheck``: in a module that declares a ``@memory_budget`` pool,
    every device allocation is reachable from one, and every declaration
    names its pool and budget;

- the runtime sanitizers: ``TTD_LOCKCHECK=1`` (``lockcheck``) wraps the
  package's locks in an acquisition-order graph that raises on a cycle
  and installs the per-attribute guards; ``TTD_MEMCHECK=1``
  (``memcheck``) ledgers the declared device pools' live bytes and
  raises ``MemoryBudgetError`` before an allocation that would exceed
  its owner's budget.

The JAX package's static ``compilecheck`` (every ``jax.jit`` site
declares its buckets, donations and statics), the dispatch checker's
jit half and memcheck's donation rule have no counterpart: the port has
no ``jax.jit`` and no ``torch.compile`` site, eager PyTorch traces
nothing, and torch has no donated buffers.  ``compilecheck`` here is the
runtime surface the fleet reads (an empty ledger), and
``compile_site`` a declaration.

One suppression format everywhere: ``# ttd-lint: disable=<checker> --
<why>`` on the offending line; the reason is mandatory and unused
suppressions are themselves findings.
"""

from tensorflow_train_distributed_torch.runtime.lint.core import (  # noqa: F401
    CHECKER_EXIT_BITS,
    Finding,
    exit_code,
    iter_source_files,
    run_lint,
)
