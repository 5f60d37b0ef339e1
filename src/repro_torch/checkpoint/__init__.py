from .checkpointer import latest, restore, save
from .elastic import restore_on_mesh

__all__ = ["latest", "restore", "save", "restore_on_mesh"]
