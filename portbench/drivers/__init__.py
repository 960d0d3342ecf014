"""Request drivers, one module a traffic ``op``, found by name: a traffic
mix whose ``op`` is ``spmv`` runs through ``drivers/spmv.py``. Each has

- ``requests(traffic, seed, n, rows, cols, device)``: the mix's requests,
  made from the seed by ``generator.py``;
- ``Driver(ctx, coo, requests, geometry, device, seed, reference)``, where
  ``reference`` is the plain reference's module that the driver names
  (``reference_name(traffic)``), with ``build``, ``warm_up``,
  ``window(seconds)``, ``traced(traffic)``, ``release``, ``end_to_end``
  and ``check(limits) -> (checks, failed)``; and ``unit`` (what the route
  line counts launches per), ``units``, ``requests`` and ``variant`` (the
  variant ``auto`` resolved, where the program returns it, else None).
"""
