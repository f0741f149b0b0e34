# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: trader.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ctrader.proto\x12\x06trader\x1a\x1egoogle/protobuf/duration.proto\"\x84\x01\n\x0f\x43ontractRequest\x12\n\n\x02id\x18\x01 \x01(\r\x12\r\n\x05\x63ores\x18\x02 \x01(\r\x12\x0e\n\x06memory\x18\x03 \x01(\r\x12\'\n\x04time\x18\x04 \x01(\x0b\x32\x19.google.protobuf.Duration\x12\r\n\x05price\x18\x05 \x01(\x02\x12\x0e\n\x06trader\x18\x06 \x01(\t\"\x96\x01\n\x10\x43ontractResponse\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0f\n\x07\x61pprove\x18\x02 \x01(\x08\x12\r\n\x05\x63ores\x18\x03 \x01(\r\x12\x0e\n\x06memory\x18\x04 \x01(\r\x12\'\n\x04time\x18\x05 \x01(\x0b\x32\x19.google.protobuf.Duration\x12\r\n\x05price\x18\x06 \x01(\x02\x12\x0e\n\x06trader\x18\x07 \x01(\t\"m\n\nNodeObject\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\r\n\x05\x63ores\x18\x03 \x01(\r\x12\x0e\n\x06memory\x18\x04 \x01(\r\x12\'\n\x04time\x18\x05 \x01(\x0b\x32\x19.google.protobuf.Duration2\x93\x01\n\x06Trader\x12\x46\n\x0fRequestResource\x12\x17.trader.ContractRequest\x1a\x18.trader.ContractResponse\"\x00\x12\x41\n\x0f\x41pproveContract\x12\x18.trader.ContractResponse\x1a\x12.trader.NodeObject\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'trader_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONTRACTREQUEST._serialized_start=57
  _CONTRACTREQUEST._serialized_end=189
  _CONTRACTRESPONSE._serialized_start=192
  _CONTRACTRESPONSE._serialized_end=342
  _NODEOBJECT._serialized_start=344
  _NODEOBJECT._serialized_end=453
  _TRADER._serialized_start=456
  _TRADER._serialized_end=603
# @@protoc_insertion_point(module_scope)
