# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: otlp_metrics_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from multi_cluster_simulator_tpu_torch.services.proto import otlp_metrics_pb2 as otlp__metrics__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1aotlp_metrics_service.proto\x12(opentelemetry.proto.collector.metrics.v1\x1a\x12otlp_metrics.proto\"h\n\x1b\x45xportMetricsServiceRequest\x12I\n\x10resource_metrics\x18\x01 \x03(\x0b\x32/.opentelemetry.proto.metrics.v1.ResourceMetrics\"~\n\x1c\x45xportMetricsServiceResponse\x12^\n\x0fpartial_success\x18\x01 \x01(\x0b\x32\x45.opentelemetry.proto.collector.metrics.v1.ExportMetricsPartialSuccess\"R\n\x1b\x45xportMetricsPartialSuccess\x12\x1c\n\x14rejected_data_points\x18\x01 \x01(\x03\x12\x15\n\rerror_message\x18\x02 \x01(\t2\xac\x01\n\x0eMetricsService\x12\x99\x01\n\x06\x45xport\x12\x45.opentelemetry.proto.collector.metrics.v1.ExportMetricsServiceRequest\x1a\x46.opentelemetry.proto.collector.metrics.v1.ExportMetricsServiceResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'otlp_metrics_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXPORTMETRICSSERVICEREQUEST._serialized_start=92
  _EXPORTMETRICSSERVICEREQUEST._serialized_end=196
  _EXPORTMETRICSSERVICERESPONSE._serialized_start=198
  _EXPORTMETRICSSERVICERESPONSE._serialized_end=324
  _EXPORTMETRICSPARTIALSUCCESS._serialized_start=326
  _EXPORTMETRICSPARTIALSUCCESS._serialized_end=408
  _METRICSSERVICE._serialized_start=411
  _METRICSSERVICE._serialized_end=583
# @@protoc_insertion_point(module_scope)
