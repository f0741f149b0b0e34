"""gRPC bindings for the trader protocol — the pkg/trader/gen equivalent.

The reference generates Go client/server stubs from its protos with protoc
(pkg/trader/gen, regenerated by proto/protoc.sh). This image has protoc but
not the Python grpc plugin, so the message classes are protoc-generated
(services/proto/) and the service method tables are written directly against
grpcio's generic-handler API — the same two services with the same method
paths:

  /trader.ResourceChannel/{Start,ProvideJobs,ReceiveVirtualNode,
                           ProvideVirtualNode}       (trader_server.go:11-94)
  /trader.Trader/{RequestResource,ApproveContract}   (trader/server.go:31-85)

The service names match the reference's generated ServiceName constants
("trader.ResourceChannel", "trader.Trader" — gen/resource-channel_grpc.pb.go:249,
gen/trader_grpc.pb.go:129) so a Go peer's stubs resolve against this server
unchanged; tests/test_wire_fixtures.py pins every FullMethod string.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Iterator, Optional

import grpc

from multi_cluster_simulator_tpu_torch.config import PROVIDE_JOBS_BATCH
from multi_cluster_simulator_tpu_torch.services import telemetry
from multi_cluster_simulator_tpu_torch.services.proto import (
    resource_channel_pb2 as rc_pb,
    trader_pb2 as t_pb,
)

_RC = "trader.ResourceChannel"
_TR = "trader.Trader"


def _trace_metadata():
    """Invocation metadata carrying the active span context, if any — the
    otelgrpc client stats-handler equivalent (pkg/trader/trader.go:216)."""
    ctx = telemetry.current_context()
    return None if ctx is None else ((telemetry.TRACE_METADATA_KEY, ctx),)


def _parent_from(context) -> Optional[str]:
    """Extract the propagated span context from a server-side gRPC context."""
    for k, v in context.invocation_metadata():
        if k == telemetry.TRACE_METADATA_KEY:
            return v
    return None


def _server_span(tracer, name, context, **attrs):
    """A server span parented on the caller's propagated context (the
    otelgrpc server stats handler, cmd/scheduler/main.go:76)."""
    if tracer is None:
        from contextlib import nullcontext
        return nullcontext()
    return tracer.start_span(name, parent=_parent_from(context),
                             kind="server", **attrs)


def start_server(handlers: list, host: str = "127.0.0.1",
                 port: int = 0) -> tuple[grpc.Server, str]:
    """Start an insecure gRPC server with the given generic handlers;
    returns (server, address). port=0 binds an ephemeral port (the
    reference uses random ports, cmd/scheduler/main.go:62-68)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    for h in handlers:
        server.add_generic_rpc_handlers((h,))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, f"{host}:{bound}"


# ---------------------------------------------------------------------------
# ResourceChannel server (hosted by the scheduler service for its trader)
# ---------------------------------------------------------------------------

def resource_channel_handler(sched, state_cadence_s: float,
                             stop: threading.Event) -> grpc.GenericRpcHandler:
    """Wrap a SchedulerService in the ResourceChannel gRPC service.

    ``sched`` provides cluster_state()/level1_jobs()/provide_virtual_node()/
    receive_virtual_node() (services/scheduler_host.py)."""

    def start(request: rc_pb.StartParams, context) -> Iterator[rc_pb.ClusterState]:
        """Stream ClusterState on the 5 s cadence; totals ride only the
        first send (the ClusterChange flag, trader_server.go:17-41)."""
        first = True
        while context.is_active() and not stop.is_set():
            s = sched.cluster_state()
            msg = rc_pb.ClusterState(
                cores_utilization=s["cores_utilization"],
                memory_utilization=s["memory_utilization"],
                average_wait_time=s["average_wait_time"])
            if first:
                msg.total_cpu = s["total_cpu"]
                msg.total_memory = s["total_memory"]
                first = False
            yield msg
            if stop.wait(state_cadence_s):
                return

    def provide_jobs(request: rc_pb.ProvideJobsRequest,
                     context) -> Iterator[rc_pb.ProvideJobsResponse]:
        """Stream Level1 in batches of 20 (trader_server.go:69-94)."""
        jobs = sched.level1_jobs()
        for i in range(0, len(jobs), PROVIDE_JOBS_BATCH):
            batch = rc_pb.ProvideJobsResponse()
            for j in jobs[i:i + PROVIDE_JOBS_BATCH]:
                pj = batch.jobs.add(cores_needed=j["cores"],
                                    memory_needed=j["mem"])
                pj.unix_time_seconds.FromMilliseconds(j["dur_ms"])
            yield batch

    def receive_virtual_node(node: t_pb.NodeObject,
                             context) -> rc_pb.VirtualNodeResponse:
        with _server_span(getattr(sched, "tracer", None),
                          "ReceiveVirtualNode", context, cores=node.cores,
                          memory=node.memory):
            sched.receive_virtual_node(node.cores, node.memory,
                                       node.time.ToMilliseconds())
        return rc_pb.VirtualNodeResponse()

    def provide_virtual_node(req: rc_pb.VirtualNodeRequest,
                             context) -> t_pb.NodeObject:
        with _server_span(getattr(sched, "tracer", None),
                          "ProvideVirtualNode", context, cores=req.cores,
                          memory=req.memory):
            ok = sched.provide_virtual_node(req.cores, req.memory,
                                            req.time.ToMilliseconds())
        if not ok:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "couldn't allocate resources on scheduler")
        node = t_pb.NodeObject(id=req.id, cores=req.cores, memory=req.memory)
        node.time.CopyFrom(req.time)
        return node

    return grpc.method_handlers_generic_handler(_RC, {
        "Start": grpc.unary_stream_rpc_method_handler(
            start, request_deserializer=rc_pb.StartParams.FromString,
            response_serializer=rc_pb.ClusterState.SerializeToString),
        "ProvideJobs": grpc.unary_stream_rpc_method_handler(
            provide_jobs,
            request_deserializer=rc_pb.ProvideJobsRequest.FromString,
            response_serializer=rc_pb.ProvideJobsResponse.SerializeToString),
        "ReceiveVirtualNode": grpc.unary_unary_rpc_method_handler(
            receive_virtual_node,
            request_deserializer=t_pb.NodeObject.FromString,
            response_serializer=rc_pb.VirtualNodeResponse.SerializeToString),
        "ProvideVirtualNode": grpc.unary_unary_rpc_method_handler(
            provide_virtual_node,
            request_deserializer=rc_pb.VirtualNodeRequest.FromString,
            response_serializer=t_pb.NodeObject.SerializeToString),
    })


class ResourceChannelClient:
    """Client stub for the scheduler's ResourceChannel
    (pkg/trader/scheduler_client.go consumers)."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address)
        p = f"/{_RC}/"
        self._start = self.channel.unary_stream(
            p + "Start", request_serializer=rc_pb.StartParams.SerializeToString,
            response_deserializer=rc_pb.ClusterState.FromString)
        self._provide_jobs = self.channel.unary_stream(
            p + "ProvideJobs",
            request_serializer=rc_pb.ProvideJobsRequest.SerializeToString,
            response_deserializer=rc_pb.ProvideJobsResponse.FromString)
        self._recv_vnode = self.channel.unary_unary(
            p + "ReceiveVirtualNode",
            request_serializer=t_pb.NodeObject.SerializeToString,
            response_deserializer=rc_pb.VirtualNodeResponse.FromString)
        self._prov_vnode = self.channel.unary_unary(
            p + "ProvideVirtualNode",
            request_serializer=rc_pb.VirtualNodeRequest.SerializeToString,
            response_deserializer=t_pb.NodeObject.FromString)

    def start(self) -> Iterator[rc_pb.ClusterState]:
        return self._start(rc_pb.StartParams())

    def provide_jobs(self) -> Iterator[rc_pb.ProvideJobsResponse]:
        return self._provide_jobs(rc_pb.ProvideJobsRequest())

    def receive_virtual_node(self, node: t_pb.NodeObject) -> None:
        self._recv_vnode(node, metadata=_trace_metadata())

    def provide_virtual_node(self, req: rc_pb.VirtualNodeRequest,
                             timeout: Optional[float] = 10.0) -> t_pb.NodeObject:
        return self._prov_vnode(req, timeout=timeout,
                                metadata=_trace_metadata())

    def close(self) -> None:
        self.channel.close()


# ---------------------------------------------------------------------------
# Trader service (hosted by the trader for peer traders)
# ---------------------------------------------------------------------------

def trader_handler(trader) -> grpc.GenericRpcHandler:
    """Wrap a TraderService's seller side in the Trader gRPC service
    (pkg/trader/server.go). ``trader`` provides request_resource(contract)
    and approve_contract(response)."""

    def request_resource(req: t_pb.ContractRequest,
                         context) -> t_pb.ContractResponse:
        # the seller-side ApproveTrade span (trader.go:143)
        with _server_span(getattr(trader, "tracer", None), "RequestResource",
                          context, cores=req.cores, memory=req.memory):
            return trader.request_resource(req)

    def approve_contract(resp: t_pb.ContractResponse,
                         context) -> t_pb.NodeObject:
        with _server_span(getattr(trader, "tracer", None), "ApproveContract",
                          context, contract_id=resp.id):
            node = trader.approve_contract(resp)
        if node is None:  # TTL expired / id mismatch (trader/server.go:70-72)
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "Time limit exceeded, contract denied")
        return node

    return grpc.method_handlers_generic_handler(_TR, {
        "RequestResource": grpc.unary_unary_rpc_method_handler(
            request_resource,
            request_deserializer=t_pb.ContractRequest.FromString,
            response_serializer=t_pb.ContractResponse.SerializeToString),
        "ApproveContract": grpc.unary_unary_rpc_method_handler(
            approve_contract,
            request_deserializer=t_pb.ContractResponse.FromString,
            response_serializer=t_pb.NodeObject.SerializeToString),
    })


class TraderClient:
    """Client stub for a peer trader (pkg/trader/client.go)."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address)
        p = f"/{_TR}/"
        self._request = self.channel.unary_unary(
            p + "RequestResource",
            request_serializer=t_pb.ContractRequest.SerializeToString,
            response_deserializer=t_pb.ContractResponse.FromString)
        self._approve = self.channel.unary_unary(
            p + "ApproveContract",
            request_serializer=t_pb.ContractResponse.SerializeToString,
            response_deserializer=t_pb.NodeObject.FromString)

    def request_resource(self, req: t_pb.ContractRequest,
                         timeout: Optional[float] = 3.0) -> t_pb.ContractResponse:
        return self._request(req, timeout=timeout, metadata=_trace_metadata())

    def approve_contract(self, resp: t_pb.ContractResponse,
                         timeout: Optional[float] = 10.0) -> t_pb.NodeObject:
        return self._approve(resp, timeout=timeout, metadata=_trace_metadata())

    def close(self) -> None:
        self.channel.close()
