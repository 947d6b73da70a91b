"""Generic registry engine (counterpart of ``unicore_tpu/registry.py``).

Each registry owns a ``--<name>`` CLI choice flag, a decorator to register
implementations, and a builder that injects the chosen class's argparse
defaults into the args namespace before construction.
``setup_registry`` returns the classic (build, register, REGISTRY-dict)
triple for call-site compatibility.
"""

import argparse

REGISTRIES = {}


class Registry:
    def __init__(self, name: str, base_class=None, default=None):
        self.name = name
        self.base_class = base_class
        self.default = default
        self.classes = {}
        self._class_names = set()

    def register(self, key):
        """Decorator: ``@register_x("key")`` adds the class under ``key``."""

        def deco(cls):
            if key in self.classes:
                raise ValueError(
                    f"Cannot register duplicate {self.name} ({key})"
                )
            if cls.__name__ in self._class_names:
                raise ValueError(
                    f"Cannot register {self.name} with duplicate class name "
                    f"({cls.__name__})"
                )
            if self.base_class is not None and not issubclass(
                cls, self.base_class
            ):
                raise ValueError(
                    f"{self.name} must extend {self.base_class.__name__}"
                )
            self.classes[key] = cls
            self._class_names.add(cls.__name__)
            return cls

        return deco

    def build(self, args, *extra_args, **extra_kwargs):
        """Instantiate the implementation ``args.<name>`` selects.

        The class's own argparse defaults are merged into ``args`` first, so
        construction sees a complete namespace even when the two-phase CLI
        parse was bypassed (tests, library use).  Classes may provide a
        ``build_<name>`` classmethod to customize construction."""
        key = getattr(args, self.name, None)
        if key is None:
            return None
        cls = self.classes[key]
        fill_defaults_from_add_args(args, cls)
        builder = getattr(cls, f"build_{self.name}", cls)
        return builder(args, *extra_args, **extra_kwargs)


def setup_registry(flag: str, base_class=None, default=None, required=False):
    assert flag.startswith("--")
    name = flag[2:].replace("-", "_")
    if name in REGISTRIES:
        raise ValueError(f"Cannot setup duplicate registry: {name}")
    reg = Registry(name, base_class=base_class, default=default)
    REGISTRIES[name] = {"registry": reg.classes, "default": default}
    return reg.build, reg.register, reg.classes


def fill_defaults_from_add_args(args, cls):
    """Set any attr missing from ``args`` to the default its ``add_args``
    flag declares."""
    if not hasattr(cls, "add_args"):
        return
    probe = argparse.ArgumentParser(
        argument_default=argparse.SUPPRESS, allow_abbrev=False
    )
    cls.add_args(probe)
    for action in probe._actions:
        if action.dest is argparse.SUPPRESS or action.default is argparse.SUPPRESS:
            continue
        if not hasattr(args, action.dest):
            setattr(args, action.dest, action.default)


# historical name used by options.py and user plugins
set_defaults = fill_defaults_from_add_args
