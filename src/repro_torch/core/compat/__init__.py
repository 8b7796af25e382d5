"""Heterogeneous compatible transmission module (paper §III-B): precision
(``precision``), parallel-strategy (``parallel_align``) and VRAM-layout
(``layout``) alignment."""
