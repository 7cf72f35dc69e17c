"""Serving layer of the port: artifact loading (the service is later work)."""
from .artifact import load_artifact
