"""Dashboard: HTML list of evaluation instances with per-instance results.

Parity: ``tools/.../dashboard/Dashboard.scala:45-160`` — an HTML index of
completed evaluations plus ``evaluator_results.{txt,html,json}`` per instance
(``Dashboard.scala:112-154``).

Counterpart of ``predictionio_tpu/tools/dashboard.py``, on the port's
``common/http.py``: the same routes, bodies and CORS headers. Host code: it
opens no CUDA context.
"""

from __future__ import annotations

import html
from typing import Optional

from predictionio_tpu_torch import obs
from predictionio_tpu_torch.common.http import HttpService, Response, json_response
from predictionio_tpu_torch.data.storage.registry import Storage


class Dashboard:
    def __init__(self, storage: Optional[Storage] = None,
                 telemetry: bool = True):
        self.storage = storage or Storage.instance()
        self.service = HttpService("dashboard")
        self.telemetry = (
            obs.Telemetry("dashboard").install(self.service)
            if telemetry and obs.telemetry_enabled()
            else None
        )
        self._register()

    CORS_HEADERS = {  # parity: tools/dashboard/CorsSupport.scala
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Methods": "GET, OPTIONS",
        "Access-Control-Allow-Headers": "Content-Type",
    }

    def _register(self):
        svc = self.service
        storage = self.storage

        _orig_dispatch = svc.dispatch

        def dispatch_with_cors(req):
            resp = _orig_dispatch(req)
            resp.headers.update(self.CORS_HEADERS)
            return resp

        svc.dispatch = dispatch_with_cors

        @svc.route("GET", r"/")
        def index(req):
            rows = []
            for i in storage.get_meta_data_evaluation_instances().get_completed():
                rows.append(
                    f"<tr><td>{html.escape(i.id)}</td>"
                    f"<td>{html.escape(i.evaluation_class)}</td>"
                    f"<td>{i.start_time:%Y-%m-%d %H:%M:%S}</td>"
                    f"<td>{i.end_time:%Y-%m-%d %H:%M:%S}</td>"
                    f"<td><a href='/engine_instances/{i.id}/evaluator_results.txt'>txt</a> "
                    f"<a href='/engine_instances/{i.id}/evaluator_results.html'>html</a> "
                    f"<a href='/engine_instances/{i.id}/evaluator_results.json'>json</a>"
                    f"</td></tr>"
                )
            body = (
                "<html><head><title>Evaluation Dashboard</title></head><body>"
                "<h1>Evaluation Instances</h1>"
                "<table border='1'><tr><th>ID</th><th>Evaluation</th>"
                "<th>Start</th><th>End</th><th>Results</th></tr>"
                + "".join(rows)
                + "</table></body></html>"
            )
            return Response(200, body)

        @svc.route(
            "GET", r"/engine_instances/(?P<iid>[^/]+)/evaluator_results\.(?P<fmt>\w+)"
        )
        def results(req):
            inst = storage.get_meta_data_evaluation_instances().get(
                req.match.group("iid")
            )
            if inst is None:
                return json_response(404, {"message": "not found"})
            fmt = req.match.group("fmt")
            if fmt == "txt":
                return Response(200, inst.evaluator_results, content_type="text/plain")
            if fmt == "html":
                return Response(200, inst.evaluator_results_html)
            if fmt == "json":
                return Response(
                    200, inst.evaluator_results_json, content_type="application/json"
                )
            return json_response(404, {"message": f"unknown format {fmt}"})

    def start(self, host: str = "127.0.0.1", port: int = 9000) -> int:
        return self.service.start(host, port)

    def stop(self) -> None:
        self.service.stop()
