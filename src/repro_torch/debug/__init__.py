"""Runtime debugging aids for the port's serving engine (see sanitize.py)."""
from repro_torch.debug.sanitize import (EngineSanitizer, SanitizeError,
                                        SanitizeReport, sanitized,
                                        transfer_allowed)

__all__ = ["EngineSanitizer", "SanitizeError", "SanitizeReport",
           "sanitized", "transfer_allowed"]
