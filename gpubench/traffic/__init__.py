"""Traffic kinds, one module each, found by the name a workload file gives
under ``kind``. A kind's module has ``Cell(ctx)``, whose constructor is the
set-up (the program built, weights and inputs made from ``ctx.seed``, every
shape of the window warmed up), and whose methods are:

* ``unit(i)``: the window's ``i``-th unit of work; returns its latency in
  seconds (host clock) or None;
* ``drain()``: wait for what the units left in flight;
* ``end_to_end(ctx)``: the cell's end-to-end metrics of the window, by
  name (the harness adds ``setup_s`` and ``peak_mem_gib``);
* ``attempted``, ``failed``: units of work attempted and failed;
* ``trace(ctx)``: profile a few more units into ``ctx.trace``
  (``gpubench/trace.py``) and leave counts for the readers in ``ctx.extra``;
* ``release()``: free the program's state;
* ``check(ctx)``: the comparison with the reference, ``[(name, value,
  limit)]``.
"""
