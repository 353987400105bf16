"""Control plane of the port (counterpart of `repro.control`): load
generation, admission control, autoscaling, and the registry behind the
``control=`` seam (see `repro_torch.control.plane`)."""

from repro_torch.control.plane import (
    ControlConfig,
    ControlLike,
    ControlPlane,
    Controller,
    AdmissionController,
    AutoscaleController,
    LoadGenController,
    available_controllers,
    controller_descriptions,
    get_controller_cls,
    make_controller,
    register_controller,
    resolve_control,
    scale_priority,
)
from repro_torch.control.simproj import CONTROL_METRIC_KEYS, CtlState, SimControl
from repro_torch.control.host import ClosedLoopClients, HostControl

__all__ = [
    "ControlConfig",
    "ControlLike",
    "ControlPlane",
    "Controller",
    "AdmissionController",
    "AutoscaleController",
    "LoadGenController",
    "available_controllers",
    "controller_descriptions",
    "get_controller_cls",
    "make_controller",
    "register_controller",
    "resolve_control",
    "scale_priority",
    "CONTROL_METRIC_KEYS",
    "CtlState",
    "SimControl",
    "ClosedLoopClients",
    "HostControl",
]
