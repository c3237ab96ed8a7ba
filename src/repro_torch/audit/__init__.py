from repro_torch.audit.trace import KNOWN_KINDS, NULL_TRACER, Tracer

__all__ = ["KNOWN_KINDS", "NULL_TRACER", "Tracer"]
