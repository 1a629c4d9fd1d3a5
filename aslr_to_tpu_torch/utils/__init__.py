"""Utilities: solution metrics, the per-iteration table, the finite-difference
oracle, the native rigid-body oracle, the URDF parser, trajectory io and
the plots (``metrics``, ``verbose``, ``numdiff``, ``native``, ``urdf``,
``io``, ``plotting``)."""
