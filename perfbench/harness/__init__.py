"""The harness: general machinery that finds each cell's files by name."""
