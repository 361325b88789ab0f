"""The roofline: per-chip FLOPs, bytes and collective bytes of a step
(``hlo_cost``), its three-term bound on an H100 (``analysis``) and the
dry run's tables (``report``)."""
