from pathtracer_torch.film.film import (
    Film,
    accumulate,
    accumulate_many,
    new_film,
    rmse,
    save_checkpoint,
    load_checkpoint,
    to_display,
    write_png,
    read_png,
)

__all__ = [
    "Film", "accumulate", "accumulate_many", "new_film", "rmse",
    "save_checkpoint", "load_checkpoint", "to_display", "write_png",
    "read_png",
]
