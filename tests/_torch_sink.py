"""A telemetry sink for the port's trainer-process tests: a TCP server on
localhost (a free port) that keeps every JSON line it is sent, the
records of ``obs/telemetry.py``'s ``TelemetryEmitter``."""

import json
import socketserver
import threading
import time


class Sink:
    def __init__(self):
        records = self.records = []
        lock = self.lock = threading.Lock()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    with lock:
                        records.append(json.loads(raw))

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def records_of(self, job: str, key: str):
        """The records of ``job`` ("namespace/name") that hold ``key``,
        once they stop coming (the count stays put for half a second)."""
        seen, since = -1, time.time()
        while time.time() - since < 0.5:
            with self.lock:
                got = [r for r in self.records
                       if r.get("job") == job and key in r]
            if len(got) != seen:
                seen, since = len(got), time.time()
            time.sleep(0.05)
        return got

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)
