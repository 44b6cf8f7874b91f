"""Serving engine: scheduler, requests, the overlapped decode loop."""
