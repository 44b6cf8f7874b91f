"""Launch drivers."""
