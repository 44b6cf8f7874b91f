"""Decision plane: RNG, penalties, sampling pipelines, backends."""
