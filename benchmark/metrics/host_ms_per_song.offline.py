"""host_ms_per_song.offline: the host work a song of the timing stretch's
`separate_many` call that does not wait on the card, in ms: the
program's `track.prepare`, `track.plan`, `track.place`, `track.alloc`
and `track.finish` spans less the `device.wait` spans inside them, over
its songs. `track.launch` and `track.download` are left out."""

from benchmark.harness.spans import host_ms_per_song, program_spans


def read(run):
    return host_ms_per_song(program_spans(run))
