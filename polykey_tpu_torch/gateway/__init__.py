"""gRPC gateway: the reference's ExecuteTool contract, served by the GPU
engine (torch_service.py) or the mock backend."""
