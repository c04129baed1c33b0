"""RPR006 fixture: DeprecationWarning without stacklevel=2."""
import warnings


def old():
    warnings.warn("old", DeprecationWarning)                 # RPR006


def old_clean():
    warnings.warn("old", DeprecationWarning, stacklevel=2)
