"""scene_build_s: the span around the SceneBuilder calls and finalize, in s."""


def read(rec):
    return rec.spans.get("scene_build")
