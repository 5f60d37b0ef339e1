from .fault_tolerance import SupervisorConfig, SupervisorReport, TrainSupervisor

__all__ = ["SupervisorConfig", "SupervisorReport", "TrainSupervisor"]
