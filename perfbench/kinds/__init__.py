"""Kinds of traffic, one module each, found by the ``kind`` that a mix in
``traffic/<mix>.json`` names (:func:`perfbench.parts.find`). A kind's module
has ``make(cfg, traffic, seed, device, dtype)``, which returns the system
under test: ``setup()``, ``unit()`` (one unit of traffic), ``work(units,
seconds)`` (the end-to-end numbers and the work done), ``release()``,
``gaps()`` (each compared number), ``attempted``, ``failed`` and
``phases``."""
