"""The roofline of the port (``src/repro/roofline/``): the H100's
constants (``hw``), the three-term model and the trace counters
(``analysis``), the analytic models of the packed rerank (``packed``)
and the PLAID probe (``probe``), the per-cell runner (``run``), named
variants (``hillclimb``) and the tables (``report``)."""
