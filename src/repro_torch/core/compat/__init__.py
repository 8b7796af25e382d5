"""Heterogeneous compatibility components: precision and parallel-strategy
alignment (layout alignment lives in ``serving.paged_cache`` and the
re-page kernel)."""
