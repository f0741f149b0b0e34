"""Generated protobuf message modules (see generate.sh)."""
