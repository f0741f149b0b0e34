#!/bin/sh
# Regenerate *_pb2.py from the proto schemas (the reference's
# pkg/trader/proto/protoc.sh analogue). grpc_tools is not available in this
# image, so only message classes are generated; the service method tables
# live in services/rpc.py over grpcio's generic handlers.
set -e
cd "$(dirname "$0")"
protoc --python_out=. trader.proto resource_channel.proto \
  otlp_common.proto otlp_resource.proto otlp_trace.proto otlp_metrics.proto \
  otlp_trace_service.proto otlp_metrics_service.proto
# package-qualify the cross-file imports for package-relative loading
sed -i -E 's/^import (trader|resource_channel|otlp_[a-z_]+)_pb2 as (\S+)$/from multi_cluster_simulator_tpu_torch.services.proto import \1_pb2 as \2/' ./*_pb2.py
