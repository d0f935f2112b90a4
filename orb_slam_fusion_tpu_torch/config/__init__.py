"""Configuration loading: the reference's YAML settings files."""

from .settings import Settings, load_settings  # noqa: F401
