"""Device/precision policy (`device`), seeded RNG (`rng`) and numpy
hand-over (`convert`)."""
