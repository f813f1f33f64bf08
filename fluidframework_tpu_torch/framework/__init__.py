"""App-facing framework layer (the aqueduct equivalent).

Reference parity: packages/framework/aqueduct — ``DataObject``,
``PureDataObject``, ``DataObjectFactory``,
``ContainerRuntimeFactoryWithDefaultDataStore`` — plus the simplified
one-call client of experimental/framework/fluid-static.
"""

from .data_object import DataObject, PureDataObject
from .data_object_factory import DataObjectFactory
from .request_handler import (
    RequestParser,
    Response,
    RuntimeRequestRouter,
    data_object_request_handler,
    datastore_request_handler,
    default_route_handler,
)
from .runtime_factory import ContainerRuntimeFactoryWithDefaultDataStore
from .fluid_static import FluidContainer, create_container, get_container
from .synthesize import DependencyContainer, DependencyError

__all__ = [
    "DataObject",
    "PureDataObject",
    "DataObjectFactory",
    "ContainerRuntimeFactoryWithDefaultDataStore",
    "DependencyContainer",
    "DependencyError",
    "FluidContainer",
    "RequestParser",
    "Response",
    "RuntimeRequestRouter",
    "create_container",
    "data_object_request_handler",
    "datastore_request_handler",
    "default_route_handler",
    "get_container",
]
