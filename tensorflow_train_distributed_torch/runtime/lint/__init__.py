"""ttd-lint's runtime half, as far as the engine and the fleet need it.

- ``registry``: the declarations (``@thread_role``, ``@locks_held``,
  ``@dispatch_critical``, ``@compile_site``, ``@memory_budget``,
  ``_GUARDED_BY`` with ``@concurrency_guarded``) the code carries and
  the sanitizers read;
- ``lockcheck``: ``TTD_LOCKCHECK=1`` wraps the package's locks in an
  acquisition-order graph that raises on a cycle and installs the
  per-attribute guards;
- ``memcheck``: ``TTD_MEMCHECK=1`` ledgers the declared device pools'
  live bytes and raises ``MemoryBudgetError`` before an allocation that
  would exceed its owner's budget.

The JAX package's static checkers (``core``, ``concurrency``,
``dispatch``, ``flags``, ``prometheus``, memcheck's AST half) and its
compile sanitizer are ROADMAP Queue 1 step 8; eager PyTorch compiles
nothing per call, so ``compile_site`` is a declaration here.
"""
