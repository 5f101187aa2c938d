"""The servers of the port: OpenAI-compatible REST (http, api_protocol, the
completion and chat handlers, api_server), gRPC (pb, grpc_server) and the
REST-to-gRPC gateway; counterpart of scalellm_tpu/serve/. Importing this
package or api_server loads no grpc or protobuf module."""
