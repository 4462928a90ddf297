"""Admin server: minimal REST admin plane.

Parity: ``tools/.../admin/AdminAPI.scala:45-130`` + ``CommandClient.scala``
(GET ``/`` status, ``/cmd/app`` list/create/delete routes).

Counterpart of ``predictionio_tpu/tools/admin.py``, on the port's
``common/http.py``: the same routes and bodies. Host code: it opens no CUDA
context.
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.common.http import HttpService, json_response
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.storage.registry import Storage


class AdminServer:
    def __init__(self, storage: Optional[Storage] = None):
        self.storage = storage or Storage.instance()
        self.service = HttpService("adminserver")
        self._register()

    def _register(self):
        svc = self.service
        storage = self.storage

        @svc.route("GET", r"/")
        def index(req):
            return json_response(
                200, {"status": "alive", "description": "admin server"}
            )

        @svc.route("GET", r"/cmd/app")
        def app_list(req):
            apps = storage.get_meta_data_apps().get_all()
            keys = storage.get_meta_data_access_keys()
            return json_response(
                200,
                [
                    {
                        "id": a.id,
                        "name": a.name,
                        "description": a.description,
                        "accessKeys": [k.key for k in keys.get_by_app_id(a.id)],
                    }
                    for a in apps
                ],
            )

        @svc.route("POST", r"/cmd/app")
        def app_new(req):
            data = req.json() or {}
            name = data.get("name")
            if not name:
                return json_response(400, {"message": "name is required"})
            app_id = storage.get_meta_data_apps().insert(
                App(0, name, data.get("description"))
            )
            if app_id is None:
                return json_response(409, {"message": f"app {name} already exists"})
            storage.get_l_events().init(app_id)
            key = storage.get_meta_data_access_keys().insert(
                AccessKey("", app_id, [])
            )
            return json_response(
                201, {"id": app_id, "name": name, "accessKey": key}
            )

        @svc.route("DELETE", r"/cmd/app/(?P<name>[^/]+)")
        def app_delete(req):
            apps = storage.get_meta_data_apps()
            app = apps.get_by_name(req.match.group("name"))
            if app is None:
                return json_response(404, {"message": "app not found"})
            storage.get_l_events().remove(app.id)
            for k in storage.get_meta_data_access_keys().get_by_app_id(app.id):
                storage.get_meta_data_access_keys().delete(k.key)
            apps.delete(app.id)
            return json_response(200, {"message": f"deleted {app.name}"})

        @svc.route("DELETE", r"/cmd/app/(?P<name>[^/]+)/data")
        def app_data_delete(req):
            apps = storage.get_meta_data_apps()
            app = apps.get_by_name(req.match.group("name"))
            if app is None:
                return json_response(404, {"message": "app not found"})
            storage.get_l_events().remove(app.id)
            storage.get_l_events().init(app.id)
            return json_response(200, {"message": f"deleted data of {app.name}"})

    def start(self, host: str = "127.0.0.1", port: int = 7071) -> int:
        return self.service.start(host, port)

    def stop(self) -> None:
        self.service.stop()
