"""Generated protobuf messages of proto/llm.proto (protoc --python_out): the
port's own copy of scalellm_tpu/serve/pb/llm_pb2.py, with the same proto
package (scalellm_tpu) and service names, so that a client of either
package's server talks to the other's."""

from scalellm_tpu_torch.serve.pb import llm_pb2

__all__ = ["llm_pb2"]
