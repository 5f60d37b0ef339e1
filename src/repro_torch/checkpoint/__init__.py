from .checkpointer import latest, restore, save

__all__ = ["latest", "restore", "save"]
