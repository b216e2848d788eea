"""Batching and scale-out over cards: `mesh` (counterpart of
`thinshelllab_tpu/parallel/`)."""
