"""The fleet tier of the port: so far the exact merge of sharded answers
(the router, caches and autoscaler are ROADMAP.md queue 1 item 13)."""
