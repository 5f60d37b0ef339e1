from .train_step import TrainState, init_state, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step"]
