"""One driver per traffic kind: `run(cell) -> Outcome`."""
