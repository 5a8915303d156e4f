"""Export: trace a step, emit StableHLO text, read it back and cost it."""
