from .jaxcfg import configure as _configure

_configure()
