"""Serving: the continuous-batching engine over the fused decode block, and
deterministic fault injection."""
from repro_torch.serve.engine import (TERMINAL_STATES, AdaptiveAdmission,
                                      AdmissionPolicy, FIFOAdmission,
                                      PriorityAdmission, Request,
                                      SamplingParams, ServeEngine,
                                      ShedLowestPriority, decode_exec_config,
                                      shape_exec_config)
from repro_torch.serve.faults import (Fault, FaultInjector, VirtualClock,
                                      drive, poison_slot_state,
                                      random_schedule)

__all__ = ["AdaptiveAdmission", "AdmissionPolicy", "FIFOAdmission",
           "Fault", "FaultInjector", "PriorityAdmission", "Request",
           "SamplingParams", "ServeEngine", "ShedLowestPriority",
           "TERMINAL_STATES", "VirtualClock", "decode_exec_config", "drive",
           "poison_slot_state", "random_schedule", "shape_exec_config"]
