# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: otlp_trace_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from multi_cluster_simulator_tpu_torch.services.proto import otlp_trace_pb2 as otlp__trace__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18otlp_trace_service.proto\x12&opentelemetry.proto.collector.trace.v1\x1a\x10otlp_trace.proto\"`\n\x19\x45xportTraceServiceRequest\x12\x43\n\x0eresource_spans\x18\x01 \x03(\x0b\x32+.opentelemetry.proto.trace.v1.ResourceSpans\"x\n\x1a\x45xportTraceServiceResponse\x12Z\n\x0fpartial_success\x18\x01 \x01(\x0b\x32\x41.opentelemetry.proto.collector.trace.v1.ExportTracePartialSuccess\"J\n\x19\x45xportTracePartialSuccess\x12\x16\n\x0erejected_spans\x18\x01 \x01(\x03\x12\x15\n\rerror_message\x18\x02 \x01(\t2\xa2\x01\n\x0cTraceService\x12\x91\x01\n\x06\x45xport\x12\x41.opentelemetry.proto.collector.trace.v1.ExportTraceServiceRequest\x1a\x42.opentelemetry.proto.collector.trace.v1.ExportTraceServiceResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'otlp_trace_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXPORTTRACESERVICEREQUEST._serialized_start=86
  _EXPORTTRACESERVICEREQUEST._serialized_end=182
  _EXPORTTRACESERVICERESPONSE._serialized_start=184
  _EXPORTTRACESERVICERESPONSE._serialized_end=304
  _EXPORTTRACEPARTIALSUCCESS._serialized_start=306
  _EXPORTTRACEPARTIALSUCCESS._serialized_end=380
  _TRACESERVICE._serialized_start=383
  _TRACESERVICE._serialized_end=545
# @@protoc_insertion_point(module_scope)
