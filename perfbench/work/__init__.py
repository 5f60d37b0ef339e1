"""The yardstick's arithmetic: the H100's peaks, each kernel's work by
formula and the model FLOPs of a step, frozen here so that a change to
the program cannot move them."""
