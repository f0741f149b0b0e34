# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: resource_channel.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from multi_cluster_simulator_tpu_torch.services.proto import trader_pb2 as trader__pb2
from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x16resource_channel.proto\x12\x06trader\x1a\x0ctrader.proto\x1a\x1egoogle/protobuf/duration.proto\"\r\n\x0bStartParams\"\xb2\x01\n\x0c\x43lusterState\x12\x19\n\x11\x63ores_utilization\x18\x01 \x01(\x02\x12\x1a\n\x12memory_utilization\x18\x02 \x01(\x02\x12\x16\n\ttotal_cpu\x18\x03 \x01(\rH\x00\x88\x01\x01\x12\x19\n\x0ctotal_memory\x18\x04 \x01(\rH\x01\x88\x01\x01\x12\x19\n\x11\x61verage_wait_time\x18\x05 \x01(\x01\x42\x0c\n\n_total_cpuB\x0f\n\r_total_memory\"h\n\x12VirtualNodeRequest\x12\n\n\x02id\x18\x01 \x01(\r\x12\r\n\x05\x63ores\x18\x02 \x01(\r\x12\x0e\n\x06memory\x18\x03 \x01(\r\x12\'\n\x04time\x18\x04 \x01(\x0b\x32\x19.google.protobuf.Duration\"\x15\n\x13VirtualNodeResponse\"\x14\n\x12ProvideJobsRequest\"0\n\x13ProvideJobsResponse\x12\x19\n\x04jobs\x18\x01 \x03(\x0b\x32\x0b.trader.Job\"h\n\x03Job\x12\x14\n\x0c\x63ores_needed\x18\x01 \x01(\r\x12\x15\n\rmemory_needed\x18\x02 \x01(\r\x12\x34\n\x11unix_time_seconds\x18\x03 \x01(\x0b\x32\x19.google.protobuf.Duration2\xa6\x02\n\x0fResourceChannel\x12\x36\n\x05Start\x12\x13.trader.StartParams\x1a\x14.trader.ClusterState\"\x00\x30\x01\x12J\n\x0bProvideJobs\x12\x1a.trader.ProvideJobsRequest\x1a\x1b.trader.ProvideJobsResponse\"\x00\x30\x01\x12G\n\x12ReceiveVirtualNode\x12\x12.trader.NodeObject\x1a\x1b.trader.VirtualNodeResponse\"\x00\x12\x46\n\x12ProvideVirtualNode\x12\x1a.trader.VirtualNodeRequest\x1a\x12.trader.NodeObject\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'resource_channel_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STARTPARAMS._serialized_start=80
  _STARTPARAMS._serialized_end=93
  _CLUSTERSTATE._serialized_start=96
  _CLUSTERSTATE._serialized_end=274
  _VIRTUALNODEREQUEST._serialized_start=276
  _VIRTUALNODEREQUEST._serialized_end=380
  _VIRTUALNODERESPONSE._serialized_start=382
  _VIRTUALNODERESPONSE._serialized_end=403
  _PROVIDEJOBSREQUEST._serialized_start=405
  _PROVIDEJOBSREQUEST._serialized_end=425
  _PROVIDEJOBSRESPONSE._serialized_start=427
  _PROVIDEJOBSRESPONSE._serialized_end=475
  _JOB._serialized_start=477
  _JOB._serialized_end=581
  _RESOURCECHANNEL._serialized_start=584
  _RESOURCECHANNEL._serialized_end=878
# @@protoc_insertion_point(module_scope)
