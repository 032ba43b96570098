"""Checkpoints: step directories of .npy leaves with an atomic rename
(``store``); the serving runtime's write-ahead-log snapshots go through
it."""
